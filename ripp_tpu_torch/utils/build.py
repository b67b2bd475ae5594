"""Build and load the CUDA kernels (the port's stand-in for the JAX
package's utils/aotcache.py and utils/jaxcfg.py: what has to exist before
the first device call).

The sources under ripp_tpu_torch/csrc/ are compiled with nvcc for sm_90a
into ONE shared library with a plain C interface and loaded with ctypes.
The field's constants (modulus words, -p^-1 mod 2^32, Montgomery one) are
macros in a generated header fp_config.h (nvcc splits a -D value at its
commas, so the word lists cannot be -D flags), so each modulus gets a
library of its own; its file name is keyed by the modulus and by a hash
of the sources, and it lives in ripp_tpu_torch/_build/ (git-ignored).
Each source is compiled to an object by its own nvcc process, all started
together, then linked.

Nothing here runs at import: `load_library(spec)` is called by the kernel
wrappers at their first launch. A missing compiler or a failed build
raises; nothing gives way to the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

_LIBS: Dict[object, ctypes.CDLL] = {}  # by FieldSpec
# seconds spent building, by library key (0.0 when the file was there)
BUILD_SECONDS: Dict[str, float] = {}
# what `nvcc -Xptxas -v` said, by library key (empty unless verbose build)
BUILD_LOG: Dict[str, str] = {}


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from source at first "
        "use and need the CUDA toolkit"
    )


def _words32(v: int, nw: int) -> List[int]:
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(nw)]


def field_config(spec) -> str:
    """Text of fp_config.h: the macros that fix one modulus into the
    library."""
    assert spec.nl % 4 == 0, spec.nl
    nw = spec.nl // 2
    p = spec.p
    n0 = (-pow(p, -1, 1 << 32)) % (1 << 32)
    one = pow(2, 32 * nw, p)  # R mod p, R = 2^(16*nl) = 2^(32*nw)

    def words(v):
        return ",".join("0x%08xu" % w for w in _words32(v, nw))

    return "\n".join([
        f"// generated for {spec.name}",
        "#pragma once",
        f"#define FP_NW {nw}",
        f"#define FP_N0 0x{n0:08x}u",
        f"#define FP_P_WORDS {words(p)}",
        f"#define FP_ONE_WORDS {words(one)}",
        "",
    ])


def _sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


@functools.lru_cache(maxsize=None)
def _source_hash() -> str:
    h = hashlib.sha1()
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:10]


@functools.lru_cache(maxsize=None)
def library_key(spec) -> str:
    ph = hashlib.sha1(str(spec.p).encode()).hexdigest()[:10]
    return f"ripp_nl{spec.nl}_{ph}_{_source_hash()}"


def build_library(spec, verbose: bool = False) -> str:
    """Compile csrc/*.cu for this modulus; returns the library's path."""
    key = library_key(spec)
    so_path = os.path.join(BUILD_DIR, f"lib{key}.so")
    if os.path.exists(so_path):
        BUILD_SECONDS.setdefault(key, 0.0)
        return so_path
    sources = _sources()
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.time()
    cfg_dir = os.path.join(BUILD_DIR, f"{key}.{os.getpid()}.cfg")
    os.makedirs(cfg_dir, exist_ok=True)
    with open(os.path.join(cfg_dir, "fp_config.h"), "w") as fh:
        fh.write(field_config(spec))
    extra = ["-Xptxas", "-v"] if verbose else []
    tag = f"{key}.{os.getpid()}"
    procs = []
    objs = []
    for src in sources:
        obj = os.path.join(
            BUILD_DIR, f"{os.path.basename(src)[:-3]}.{tag}.o")
        objs.append(obj)
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", cfg_dir, "-I", CSRC_DIR,
               "-c", src, "-o", obj]
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    failed = []
    for src, proc in procs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append((src, out))
    try:
        if failed:
            raise RuntimeError(
                "nvcc failed:\n" + "\n".join(
                    f"--- {s}\n{o}" for s, o in failed))
        tmp = f"{so_path}.tmp.{os.getpid()}"
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(tmp, so_path)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
        shutil.rmtree(cfg_dir, ignore_errors=True)
    BUILD_SECONDS[key] = time.time() - t0
    BUILD_LOG[key] = "".join(log)
    return so_path


_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ULL = ctypes.c_ulonglong

# C entry points: every pointer and the stream are c_void_p (without
# argtypes ctypes would cut a 64-bit pointer to 32 bits)
_SIGNATURES = {
    # a, b, out, n, stream
    "ripp_fp_mul": [_VP, _VP, _VP, _LL, _VP],
    "ripp_fp_mul_hybrid8": [_VP, _VP, _VP, _LL, _VP],
    # op, a, b, out, n, stream
    "ripp_fp_cheap": [_I, _VP, _VP, _VP, _LL, _VP],
    # tab, n_instr, consts, in, in_regs, n_in, masks, mask_regs, n_mask,
    # out, out_regs, n_out, regs, batch, threads, stream
    "ripp_kexec": [_VP, _I, _VP, _VP, _VP, _I, _VP, _VP, _I,
                   _VP, _VP, _I, _VP, _LL, _I, _VP],
    # dbl_tab, n_dbl, add_tab, n_add, consts, bits, nbits, in, out, regs,
    # batch, threads, stream
    "ripp_miller": [_VP, _I, _VP, _I, _VP, _ULL, _I, _VP, _VP, _VP,
                    _LL, _I, _VP],
    # dbl_tab, n_dbl, add_tab, n_add, cp_tab, n_cp, consts, bits, nbits,
    # bit_step, elem_step, d, in, out, regs, batch, threads, stream
    "ripp_ladder": [_VP, _I, _VP, _I, _VP, _I, _VP, _VP, _I, _LL, _LL, _I,
                    _VP, _VP, _VP, _LL, _I, _VP],
    # tab, n_instr, consts, mask_regs, n_mask, bits, nbits, in, out, regs,
    # batch, threads, stream
    "ripp_gtexp": [_VP, _I, _VP, _VP, _I, _VP, _I, _VP, _VP, _VP, _LL, _I,
                   _VP],
}


def load_library(spec, verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library for this modulus (built at first use)."""
    lib = _LIBS.get(spec)
    if lib is None:
        lib = ctypes.CDLL(build_library(spec, verbose=verbose))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I
        _LIBS[spec] = lib
    return lib
