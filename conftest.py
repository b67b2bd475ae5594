"""Collection order only: the PyTorch/CUDA port's tests run first.

The whole suite is cut by a time limit before it reaches its end, and
files run in alphabetical order, so tests/test_torch_*.py (which sort
after test_protocols) would never run. This hook stable-sorts the
collected items so that files named test_torch_* come first; everything
else keeps its order. It does nothing else.
"""


def pytest_collection_modifyitems(config, items):
    items.sort(key=lambda item: not item.path.name.startswith("test_torch_"))
