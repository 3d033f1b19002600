"""Build the package's CUDA sources into shared libraries and load them.

Each `csrc/<name>.cu` is compiled by its own `nvcc` for `sm_90a` into
`build/torch_kernels/lib<name>-<hash>.so` at the repository root, with a
plain C interface loaded through ctypes. The file name carries a hash of the
source and the shared headers, so an edited source is rebuilt and a stale
library is never loaded. Nothing is compiled at import time: the first
kernel call (or `build_all`) does it.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
SOURCES = ("flash_fwd", "flash_bwd", "flash_dq", "flash_dkv", "flash_so", "flash_so_row",
           "flash_so_col", "dropout_mask")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded = {}


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name):
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers)
    return src, BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all(names=SOURCES):
    """Compile every missing library, one nvcc per source, all at once.
    Returns {name: (ptxas report, seconds its nvcc took)}; raises if any
    build fails, after stopping the others."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        # the report goes to a file, so no nvcc waits on a pipe nobody reads
        log = tmp.with_suffix(".log").open("w+")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                       log, tmp, out, time.perf_counter())
    reports = {}
    try:
        while procs:
            for name, (proc, log, tmp, out, t0) in list(procs.items()):
                if proc.poll() is None:
                    continue
                secs = time.perf_counter() - t0
                del procs[name]
                log.seek(0)
                text = log.read()
                log.close()
                os.unlink(log.name)
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for {name}.cu:\n{text}")
                os.replace(tmp, out)
                reports[name] = (text, secs)
            time.sleep(0.02)
    finally:
        for proc, log, tmp, *_ in procs.values():
            proc.kill()
            proc.wait()
            log.close()
            os.unlink(log.name)
            tmp.unlink(missing_ok=True)
    return reports


def library_path(name):
    """Where `lib<name>` is (or will be) built for the current sources."""
    return _target(name)[1]


def load(name):
    """The ctypes handle of `lib<name>`, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        _, out = _target(name)
        if not out.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(out))
        _loaded[name] = lib
    return lib
