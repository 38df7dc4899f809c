"""Build the CUDA sources of ``nnaudio_tpu_torch/csrc`` and load them.

Each ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, bound with ``ctypes``. The libraries go to
``nnaudio_tpu_torch/_build/<hash>/``, keyed on the sources, the headers they
share (``csrc/*.cuh``) and the flags, and are
built at first use: all sources at once, one ``nvcc`` each, in parallel.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: seconds the last build took, and nvcc's register / shared-memory report
build_info: dict[str, object] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _build_dir(sources: list[Path]) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every source that is not built yet, then load all of them.
    Raises with nvcc's output if a compile fails."""
    with _lock:
        if _libs:
            return _libs
        sources = _sources()
        out_dir = _build_dir(sources)
        out_dir.mkdir(parents=True, exist_ok=True)
        start = time.perf_counter()
        jobs = []
        for src in sources:
            lib = out_dir / f"lib{src.stem}.so"
            if lib.exists():
                continue
            tmp = out_dir / f".lib{src.stem}.{os.getpid()}.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((src, lib, tmp, proc))
        reports = {}
        failed = []
        for src, lib, tmp, proc in jobs:
            log, _ = proc.communicate()
            reports[src.name] = log
            if proc.returncode != 0:
                failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        build_info["seconds"] = time.perf_counter() - start
        build_info["compiled"] = [src.name for src, *_ in jobs]
        build_info["ptxas"] = reports
        for src in sources:
            _libs[src.stem] = ctypes.CDLL(str(out_dir / f"lib{src.stem}.so"))
        return _libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    return build_all()[name]
