"""Collection order, and one torch thread a test worker.

The whole suite is cut by a time limit before it reaches its end, and
files run in alphabetical order, so tests/test_torch_*.py (which sort
after test_protocols) would never run. This hook stable-sorts the
collected items so that files named test_torch_* come first; everything
else keeps its order.

Under pytest-xdist each worker process would start torch with one
intra-op thread a core, and the workers' pools would spin against each
other on the shared cores; a worker therefore gives torch one thread.
"""

import os


def pytest_configure(config):
    if os.environ.get("PYTEST_XDIST_WORKER"):
        import torch

        torch.set_num_threads(1)


def pytest_collection_modifyitems(config, items):
    items.sort(key=lambda item: not item.path.name.startswith("test_torch_"))
