"""Build the CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` (all started
together) for ``sm_90a`` into a shared library with a plain C interface
(no PyTorch headers, so a build takes seconds) under
``distpow_tpu_torch/build/``, or the directory ``DISTPOW_TORCH_BUILD_DIR``
names, or the one ``set_build_dir`` sets (the worker's
``CompilationCacheDir``).  A library's file name carries a hash of its
source, the shared headers and the flags, so a stale build is never
loaded.  Nothing happens
at import time: the first ``load_library`` call builds that one library
and loads it; ``build()`` builds them all (a backend's ``warmup`` builds its
own before the first request).

md5's source is built once per tail layout: ``md5_search.cu`` with
``-DDISTPOW_VAR_WORD=<w>`` holds the kernels of the tails whose run of
variable bytes starts at message word ``w`` (``VAR_WORDS``), and its
library, ``md5_search.vw<w>`` here, is built at the first launch at that
layout, the way the reference's Pallas step compiled per ``TailSpec``.

Each library ``<model>_search`` exports five C functions:
``distpow_<model>_search``, the search of one request,
``distpow_<model>_group_search``, the scheduler's search of a group of
slots (``hash_cuda.hash_group_search``), and
``distpow_<model>_mesh_search``, one shard's launch of a search spread
over a mesh of devices (``hash_cuda.hash_mesh_search``); and the
persistent forms of the first and the third,
``distpow_<model>_persistent_search`` and
``distpow_<model>_mesh_persistent_search``
(``hash_cuda.hash_persistent_search``, ``hash_mesh_persistent_search``).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.environ.get("DISTPOW_TORCH_BUILD_DIR") or os.path.join(PKG_DIR, "build")

# -Xptxas -v prints each kernel's registers and spills into the build log.
# --split-compile 0 lets one nvcc optimise and assemble its kernels on every
# core: a source holds some 40-60 kernels (the solo, group and mesh forms),
# and the longest source's build bounds the parallel build of all nine.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile", "0")

# Sources built once per var_word, the message word where a tail's run of
# variable bytes starts: source -> the var_words it is built for
VAR_WORDS = {"md5_search": range(0, 16)}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# What the last build() did: seconds of wall time (0.0 when every library
# was already built) and nvcc's output per source.
last_build_s = 0.0
last_build_log: Dict[str, str] = {}


def find_cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    for cand in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        f"{name} not found: the CUDA kernels are built on a machine with the "
        f"CUDA toolkit (PATH or /usr/local/cuda/bin)"
    )


def sources() -> List[str]:
    """Kernel names: one per ``csrc/<name>.cu``."""
    return [os.path.basename(p)[:-3]
            for p in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))]


def library_key(name: str, var_word: Optional[int] = None) -> str:
    """The library of source ``name``, at ``var_word`` for a source built
    per var_word (``md5_search.vw1``); raises for a var_word it is not
    built for, or for none where it needs one."""
    if name not in VAR_WORDS:
        if var_word is not None:
            raise ValueError(f"{name} is not built per var_word")
        return name
    if var_word not in VAR_WORDS[name]:
        raise ValueError(f"{name} is built for var_words {VAR_WORDS[name]}, not {var_word}")
    return f"{name}.vw{var_word}"


def libraries(names: Optional[Sequence[str]] = None) -> List[str]:
    """The libraries of ``names`` (sources or libraries; all sources by
    default): a source built per var_word stands for all of its libraries."""
    out = []
    for name in sources() if names is None else names:
        if name in VAR_WORDS:
            out += [library_key(name, w) for w in VAR_WORDS[name]]
        else:
            out.append(name)
    return out


def _split(key: str):
    """A library's source and ``-D`` flags."""
    name, _, vw = key.partition(".vw")
    return name, ([f"-DDISTPOW_VAR_WORD={int(vw)}"] if vw else [])


def library_path(key: str) -> str:
    """Where library ``key``'s build at its source's current contents
    lives."""
    name, defines = _split(key)
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    for path in [os.path.join(CSRC_DIR, f"{name}.cu"), *headers]:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{key}_{h.hexdigest()[:16]}.so")


def build(names: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Compile every library (or those of ``names``, sources or libraries,
    as ``libraries`` reads them) not built at its source's current
    contents, one nvcc each, all at once; return ``{library: path}``."""
    global last_build_s, last_build_log
    paths = {key: library_path(key) for key in libraries(names)}
    todo = {name: p for name, p in paths.items() if not os.path.exists(p)}
    last_build_s, last_build_log = 0.0, {}
    if not todo:
        return paths
    nvcc = find_cuda_tool("nvcc")
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.monotonic()
    procs = {}
    for key, path in todo.items():
        name, defines = _split(key)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *defines, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), tmp, cmd)
    failed = []
    for name, (proc, tmp, cmd) in procs.items():
        out, _ = proc.communicate()
        last_build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
        else:
            os.replace(tmp, todo[name])
    last_build_s = time.monotonic() - t0
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def set_build_dir(path: str) -> None:
    """Build libraries in, and load them from, ``path`` from now on: the
    worker's ``CompilationCacheDir``, so that a later boot on the same
    machine loads what an earlier one built.  Libraries loaded already stay
    loaded."""
    global BUILD_DIR
    with _lock:
        BUILD_DIR = os.path.abspath(path)


def group_function(name: str) -> str:
    """The group search's C function in library ``name`` (``md5_search``:
    ``distpow_md5_group_search``)."""
    return f"distpow_{name[:-len('_search')]}_group_search"


def mesh_function(name: str) -> str:
    """The mesh shard's C function in library ``name`` (``md5_search``:
    ``distpow_md5_mesh_search``)."""
    return f"distpow_{name[:-len('_search')]}_mesh_search"


def persistent_function(name: str) -> str:
    """The persistent solo search's C function in library ``name``
    (``md5_search``: ``distpow_md5_persistent_search``)."""
    return f"distpow_{name[:-len('_search')]}_persistent_search"


def mesh_persistent_function(name: str) -> str:
    """The persistent mesh shard's C function in library ``name``
    (``md5_search``: ``distpow_md5_mesh_persistent_search``)."""
    return f"distpow_{name[:-len('_search')]}_mesh_persistent_search"


_vp, _u32, _i32 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int
# the group search's arguments (hash_search.cuh DISTPOW_GROUP_FUNCTION)
GROUP_ARGTYPES = [
    _vp, _vp, _vp,           # init[n_slots][S], base[n_slots][n_blocks * W], masks[n_slots][D]
    _i32,                    # n_blocks
    _i32, _i32, _u32,        # var_word, var_shift, chunk_mask
    _vp, _vp, _vp,           # tb_lo[n_slots], log_tbc[n_slots], chunk0[n_slots]
    _i32, _u32, _u32,        # n_slots, batch, rounds
    _vp, _i32, _vp,          # out[2 * n_slots], grid, stream
]


def _declare(name: str, lib: ctypes.CDLL) -> None:
    """Set the argument and result types of the five C functions of each
    library; every search kernel has the same interface."""
    vp, u32, i32 = _vp, _u32, _i32
    fn = getattr(lib, f"distpow_{name}")
    fn.argtypes = [
        vp, vp, vp,          # init, base, masks
        i32, i32,            # n_blocks, mask_words
        u32, u32, u32, i32,  # chunk0, tb_lo, tbc, log_tbc
        i32, i32, u32,       # var_word, var_shift, chunk_mask
        u32, vp, i32, vp,    # n, out, grid, stream
    ]
    fn.restype = i32
    group = getattr(lib, group_function(name))
    group.argtypes = GROUP_ARGTYPES
    group.restype = i32
    mesh = getattr(lib, mesh_function(name))
    mesh.argtypes = fn.argtypes[:13] + [
        u32, u32, u32,       # origin_chunk0, origin_tb_lo, origin_tbc
        vp, i32, vp,         # out, grid, stream
    ]
    mesh.restype = i32
    persist = [vp, u32, u32]  # stop, seg, rounds
    solo_p = getattr(lib, persistent_function(name))
    solo_p.argtypes = fn.argtypes[:13] + persist + fn.argtypes[13:]
    solo_p.restype = i32
    mesh_p = getattr(lib, mesh_persistent_function(name))
    mesh_p.argtypes = mesh.argtypes[:16] + persist + mesh.argtypes[16:]
    mesh_p.restype = i32


def load_library(name: str, var_word: Optional[int] = None) -> ctypes.CDLL:
    """Build if needed, load ``csrc/<name>.cu``'s library (at ``var_word``
    for a source built per var_word) once, declare types."""
    key = library_key(name, var_word)
    with _lock:
        if key not in _libs:
            path = library_path(key)
            # built already (by build() of several at once): no build call,
            # which would reset last_build_s
            lib = ctypes.CDLL(path if os.path.exists(path) else build([key])[key])
            _declare(name, lib)
            _libs[key] = lib
        return _libs[key]
