"""Build and load the port's CUDA kernels.

Each kernel is one ``.cu`` source with a plain C interface, compiled by
``nvcc`` into a shared library and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  Libraries are keyed by a hash of the
source and the flags and land in ``build/kernels/`` at the root of the
checkout (``REPRO_TORCH_BUILD_DIR`` overrides it), which git ignores; a
library whose key is already there is loaded as it is.

``build_all`` starts one ``nvcc`` per missing library, all at once, and
waits for them together.  Nothing here runs at import: the CPU tests
import every module on machines without ``nvcc``.

Each source gets the common flags plus its own (``SOURCE_FLAGS``).  Only
``iou_matrix.cu`` is built with ``--fmad=false``: its contract is bit
equality with the numpy reference, and a contracted ``a*b+c`` (one FMA,
one rounding) differs from numpy's two roundings.  The flash-attention and
SSD kernels are held to their plain versions within a float32 tolerance,
so nvcc may contract their products into FMAs, as their speed needs.

Every source may include the shared headers of ``include/`` (the 3xTF32
mma and cp.async helpers) and the headers beside it in its own directory
(``flash_attention/csrc/flash_tile.cuh``, the tile that two flash
libraries instantiate); a library's key covers those headers too.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence, Tuple

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCE_FLAGS: Dict[str, Tuple[str, ...]] = {
    "iou_matrix.cu": ("--fmad=false",),
}

INCLUDE_DIR = Path(__file__).resolve().parent / "include"

_LOADED: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/build.py -> the checkout's root
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built at "
                           "first use on a machine with the CUDA toolkit")
    return found


def nvcc_flags(source: Path) -> Tuple[str, ...]:
    return NVCC_FLAGS + SOURCE_FLAGS.get(Path(source).name, ())


def library_path(source: Path) -> Path:
    own = sorted(Path(source).resolve().parent.glob("*.cuh"))
    headers = b"".join(h.read_bytes()
                       for h in sorted(INCLUDE_DIR.glob("*.cuh")) + own)
    key = hashlib.sha256(Path(source).read_bytes() + headers
                         + " ".join(nvcc_flags(source)).encode()
                         ).hexdigest()[:16]
    return build_dir() / f"{Path(source).stem}-{key}.so"


def build_all(sources: Sequence[Path]) -> Dict[Path, Path]:
    """Compile every source whose library is missing, all ``nvcc``
    processes running at once.  Returns source -> library path; raises
    ``RuntimeError`` with the compiler's output if any build fails.  The
    ptxas resource report of each build is kept beside its library
    (``<name>.log``)."""
    out = {Path(s): library_path(Path(s)) for s in sources}
    todo = {s: lib for s, lib in out.items() if not lib.exists()}
    if not todo:
        return out
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for src, lib in todo.items():
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[src] = (subprocess.Popen(
            [nvcc, *nvcc_flags(src), "-I", str(INCLUDE_DIR), "-o", str(tmp),
             str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, lib)
    failed = []
    for src, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, building it first if needed."""
    key = str(Path(source).resolve())
    lib = _LOADED.get(key)
    if lib is None:
        path = build_all([Path(source)])[Path(source)]
        lib = _LOADED[key] = ctypes.CDLL(str(path))
    return lib
