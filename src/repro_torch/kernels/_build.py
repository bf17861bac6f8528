"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

Each source becomes its own shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` and loaded with ``ctypes``.  The build
runs at first use: :func:`build_all` starts one ``nvcc`` per source, all
together, and waits for them.  A library's file name carries a hash of its
source, the shared headers and the flags, so a stale library is never
loaded.  The libraries go to ``build/kernels`` at the root of the checkout,
which ``.gitignore`` lists.  A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

__all__ = ["build_all", "load", "BUILD_LOG", "BUILD_SECONDS", "CSRC", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

BUILD_LOG: dict[str, str] = {}  # source stem -> nvcc output of this process
BUILD_SECONDS: dict[str, float] = {}  # source stem -> seconds its nvcc took
_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "repro_torch: nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
            "the CUDA kernels cannot be built"
        )
    return str(path)


def _target(source: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Build every ``csrc/*.cu`` that has no up-to-date library, one
    ``nvcc`` per source in parallel.  Returns ``{stem: library path}``;
    each source's nvcc output goes to :data:`BUILD_LOG` and its seconds
    (start of the build to the end of its ``nvcc``) to
    :data:`BUILD_SECONDS`."""
    sources = sorted(CSRC.glob("*.cu"))
    targets = {s.stem: _target(s) for s in sources}
    todo = [(s, targets[s.stem]) for s in sources if not targets[s.stem].exists()]
    if not todo:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    t0 = time.perf_counter()
    for source, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = tempfile.TemporaryFile(mode="w+")  # a pipe could fill and stall nvcc
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(source)]
        procs.append((source, out, tmp, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT, text=True)))
    running = list(procs)
    while running:
        for item in list(running):
            if item[4].poll() is not None:
                BUILD_SECONDS[item[0].stem] = time.perf_counter() - t0
                running.remove(item)
        time.sleep(0.02)
    failed = []
    for source, out, tmp, log, proc in procs:
        log.seek(0)
        BUILD_LOG[source.stem] = log.read()
        log.close()
        if proc.returncode != 0:
            failed.append(f"{source.name}:\n{BUILD_LOG[source.stem]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("repro_torch: nvcc failed for " + "\n".join(failed))
    return targets


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (building every
    kernel on the first call)."""
    with _lock:
        if stem not in _libs:
            for name, path in build_all().items():
                _libs.setdefault(name, ctypes.CDLL(str(path)))
        if stem not in _libs:
            raise KeyError(f"no kernel source csrc/{stem}.cu")
        return _libs[stem]
