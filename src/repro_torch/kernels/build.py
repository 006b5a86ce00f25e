"""Build the hand-written CUDA kernels of ``repro_torch/csrc`` and load them.

Each ``csrc/*.cu`` file has a plain C interface. It is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library and loaded through
``ctypes``; no PyTorch header is involved, so a build takes seconds. The
library lands in ``build/repro_torch/`` at the root of the checkout (listed
in ``.gitignore``), named by a hash of its source and flags, so an edited
source is rebuilt and an unchanged one is reused within a checkout.

Nothing here runs at import time: a kernel is built on the first launch
(``CudaLibrary.get``), or ahead of it by ``build_all``, which starts one
``nvcc`` per source at once and waits for all of them.

Every C entry point returns a ``cudaError_t``; ``CudaLibrary.check`` raises
``RuntimeError`` for a non-zero code. Launches go on PyTorch's current
stream and allocate nothing: the wrappers allocate with ``torch.empty``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

#: Hopper with the architecture-specific features (wgmma, setmaxnreg);
#: no --use_fast_math anywhere: the routing DP must stay bit-exact and the
#: attention kernel keeps IEEE expf / division
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "are built on a machine with the CUDA toolkit")


def library_path(source: str) -> Path:
    """Where ``csrc/<source>`` builds to: keyed by its content and flags."""
    text = (CSRC_DIR / source).read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:12]}.so"


def _start(source: str) -> Optional[subprocess.Popen]:
    """Launch nvcc for one source (None when its library is up to date).
    The library is written under a temporary name and renamed when the
    build succeeds, so a reader never sees a half-written file."""
    out = library_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.repro_paths = (tmp, out)          # type: ignore[attr-defined]
    return proc


def _finish(source: str, proc: Optional[subprocess.Popen]) -> str:
    """Wait for one build; returns nvcc's output (registers, shared
    memory and spills per kernel from ``-Xptxas -v``)."""
    if proc is None:
        return ""
    log, _ = proc.communicate()
    tmp, out = proc.repro_paths            # type: ignore[attr-defined]
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{source} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    (out.with_suffix(".log")).write_text(log)
    return log


def build_all(sources: Sequence[str]) -> Dict[str, str]:
    """Build every source in parallel (one nvcc each, all started before
    any is waited on). Returns {source: nvcc output}."""
    procs = [(s, _start(s)) for s in sources]
    logs = {}
    errors: List[str] = []
    for s, p in procs:
        try:
            logs[s] = _finish(s, p)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


class CudaLibrary:
    """One ``csrc`` source, built on first use and loaded with ctypes.

    ``symbols`` maps each exported C function to its argument types; every
    function returns a ``cudaError_t`` (``ctypes.c_int``). Each source also
    exports ``repro_cuda_error_string`` for the error's name."""

    def __init__(self, source: str, symbols: Dict[str, Sequence]):
        self.source = source
        self.symbols = dict(symbols)
        self._lib: Optional[ctypes.CDLL] = None

    def get(self) -> ctypes.CDLL:
        if self._lib is None:
            _finish(self.source, _start(self.source))
            lib = ctypes.CDLL(str(library_path(self.source)))
            for name, argtypes in self.symbols.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def check(self, code: int, what: str) -> None:
        """Raise when a C entry point returned a CUDA error."""
        if code != 0:
            name = self.get().repro_cuda_error_string(code).decode()
            raise RuntimeError(f"{what}: CUDA error {code} ({name})")
