"""Build and load the port's CUDA kernels.

Each `flashy_tpu_torch/csrc/<name>.cu` has a plain C interface; on
first use it is compiled with `nvcc` for `sm_90a` into a shared library
under `build/flashy_tpu_torch/` (beside the package, listed in
`.gitignore`) and loaded with `ctypes`. Libraries are named by a digest
of their source and flags, so an edited source rebuilds and an
unchanged one loads at once. Nothing is linked in beyond the CUDA
runtime and nothing is downloaded.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
import typing as tp
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "flashy_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# csrc/flash_tile.cuh `hopper::kTensorMapError`: an entry point returns it
# plus the CUresult of cuTensorMapEncodeTiled when it cannot encode a TMA
# tensor map
TENSOR_MAP_ERROR = 1_000_000

# name -> loaded library, and name -> (seconds, compiler output) of the
# build this process ran (empty when the library was already built)
_loaded: tp.Dict[str, ctypes.CDLL] = {}
build_info: tp.Dict[str, tp.Tuple[float, str]] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises where there is none."""
    found = shutil.which("nvcc")
    if found is None and Path("/usr/local/cuda/bin/nvcc").exists():
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "on a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` builds to (digest of sources + flags)."""
    digest = hashlib.sha256()
    for source in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        digest.update(source.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> None:
    """Compile `csrc/<name>.cu` unless it is built already; records the
    compile time and the compiler's output in `build_info`."""
    target = library_path(name)
    if target.exists():
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    partial = target.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    result = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(partial), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if result.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (exit "
                           f"{result.returncode}):\n{result.stdout}")
    os.replace(partial, target)
    build_info[name] = (time.perf_counter() - t0, result.stdout)


def load(name: str, functions: tp.Mapping[str, tp.Tuple[tp.Any, tp.Sequence]]
         ) -> ctypes.CDLL:
    """Build if needed, load, and declare `functions` ({symbol:
    (restype, argtypes)}) on the library."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        for symbol, (restype, argtypes) in functions.items():
            fn = getattr(lib, symbol)
            fn.restype = restype
            fn.argtypes = list(argtypes)
        _loaded[name] = lib
    return lib


def launch_error(what: str, err: int) -> RuntimeError:
    """The error for an entry point's non-zero return `err`: a
    cudaError_t, or TENSOR_MAP_ERROR + the CUresult of a refused tensor
    map."""
    if err >= TENSOR_MAP_ERROR:
        return RuntimeError(f"{what}: cuTensorMapEncodeTiled refused a TMA "
                            f"tensor map (CUresult {err - TENSOR_MAP_ERROR})")
    return RuntimeError(f"{what}: cudaError {err}")
