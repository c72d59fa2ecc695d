"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``build/deepspeed_tpu_torch/lib<name>_<hash>.so`` at the
repository root (``build/`` is git-ignored), then loaded with ``ctypes``. The
hash covers the source, every shared header of ``csrc/`` (``*.cuh``) and the
flags, so an edited source or header rebuilds and an unchanged one is built
once per checkout. Nothing here runs at import time:
the first launch of a kernel builds it.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# every kernel source of the port, built together by ``build(*SOURCES)``
SOURCES = ("paged_attention", "flash_attention", "grouped_gemm", "quant_collective",
           "quantized_matmul", "block_sparse_attention")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "deepspeed_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "from source on the machine with the GPU")
    return nvcc


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build(*names, verbose=False):
    """Compile the named kernels, one ``nvcc`` per source, all started
    together. Returns ``{name: compiler log}`` (``-Xptxas -v`` register and
    shared-memory report when ``verbose``); an already built library is
    skipped with an empty log. Raises with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    logs = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, so) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc {name}.cu exited {proc.returncode}:\n{logs[name]}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))
