"""Build and bind the port's hand-written CUDA kernels.

Each kernel family is one ``.cu`` file under its package's ``csrc/`` with
a plain C interface. ``Library`` compiles it with ``nvcc`` for ``sm_90a``
at first use into ``<repo>/build/<name>/`` (once per source version: the
file name carries a hash of the source and the flags), loads the shared
library with ctypes and sets each entry point's argument types. Every
entry point launches on the stream it is given, does not synchronise and
returns ``cudaGetLastError()``; ``Library.call`` raises on a non-zero
code, so a refused launch fails where it happened.

``build_all`` runs several libraries' ``nvcc`` at once (one process per
source), which is how a script that needs every kernel builds them up
front.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[3]
BUILD_ROOT = REPO / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    cands = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home:
            cands.append(os.path.join(home, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "their CUDA sources at first use and need the CUDA "
                       "toolkit")


class Library:
    """One CUDA source built into one shared library.

    ``sigs`` maps each C entry point to its ctypes argument types (all
    return int); ``error_fn`` names the entry point that turns a CUDA error
    code into its message."""

    def __init__(self, name: str, src: Path, sigs: dict, error_fn: str):
        self.name = name
        self.src = Path(src)
        self.sigs = sigs
        self.error_fn = error_fn
        self.build_dir = BUILD_ROOT / name
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def build(self) -> Path:
        """Compile (once per source version) -> path of the .so. nvcc's
        output is kept beside it (``.log``), so ``build_log`` holds the
        ptxas report also when the library was built earlier."""
        src = self.src.read_bytes()
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
        out = self.build_dir / f"lib{self.name}-{tag}.so"
        log = out.with_suffix(".log")
        if out.exists():
            if log.exists():
                self.build_log = log.read_text()
            return out
        self.build_dir.mkdir(parents=True, exist_ok=True)
        tmp = self.build_dir / f".lib{self.name}-{tag}.{os.getpid()}.tmp.so"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        self.build_log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}): "
                               f"{' '.join(cmd)}\n{self.build_log}")
        log.write_text(self.build_log)
        os.replace(tmp, out)
        return out

    def load(self):
        """Build (first use) and bind the library, once per process."""
        if self._lib is not None:
            return self._lib
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for fn, args in self.sigs.items():
                    f = getattr(lib, fn)
                    f.argtypes = args
                    f.restype = ctypes.c_int
                err = getattr(lib, self.error_fn)
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._lib = lib
        return self._lib

    def call(self, fn: str, *args):
        """Run one entry point; raise if it reports a CUDA error."""
        lib = self.load()
        rc = getattr(lib, fn)(*args)
        if rc != 0:
            msg = getattr(lib, self.error_fn)(rc).decode()
            raise RuntimeError(f"{fn}: CUDA error {rc}: {msg}")

    def ptxas_lines(self) -> list:
        """The register / shared-memory / spill lines of the last build."""
        return [ln.strip() for ln in self.build_log.splitlines()
                if "Used" in ln or "Function properties" in ln
                or "spill" in ln]


def build_all(libs) -> list:
    """Build several libraries at once (one nvcc process each)."""
    libs = list(libs)
    with ThreadPoolExecutor(max(1, len(libs))) as ex:
        return list(ex.map(lambda lib: lib.build(), libs))


def stream_of(t) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer-sized int."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
