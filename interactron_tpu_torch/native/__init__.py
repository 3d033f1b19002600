"""Native (C++) host-runtime components of the port (counterpart of
interactron_tpu/native/).

`get_fastloader()` returns the compiled JPEG episode loader
(`fastloader.cpp`), building it at first use with g++ and libjpeg into
`build/native/_fastloader-<hash><ext>` at the repository root (the name
carries a hash of the source and of numpy's version, so an edited source
is rebuilt). Where the
toolchain or `jpeglib.h` is missing it returns None, after one warning
that names why, and the dataset decodes with PIL, as the JAX package does.
`fastloader_status()` says which: (module or None, reason or None).
"""

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import warnings
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "fastloader.cpp"
BUILD_DIR = _SRC.parents[2] / "build" / "native"

_state = {}


def _target():
    import numpy as np

    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    # numpy's version too: the module is built against its C API
    digest = hashlib.sha256(_SRC.read_bytes() + np.__version__.encode()).hexdigest()[:12]
    return BUILD_DIR / f"_fastloader-{digest}{suffix}"


def _build(out):
    import numpy as np

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
           f"-I{sysconfig.get_paths()['include']}", f"-I{np.get_include()}",
           str(_SRC), "-ljpeg", "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
        os.replace(tmp, out)  # atomic: concurrent builders each write their own tmp
    finally:
        tmp.unlink(missing_ok=True)


def _load():
    out = _target()
    try:
        if not out.exists():
            _build(out)
    except FileNotFoundError as exc:
        return None, f"no C++ compiler ({exc.filename})"
    except subprocess.CalledProcessError as exc:
        lines = (exc.stderr or "").strip().splitlines()
        return None, f"g++ failed: {lines[0] if lines else exc}"
    except subprocess.TimeoutExpired:
        return None, "g++ timed out"
    spec = importlib.util.spec_from_file_location("_fastloader", out)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    except ImportError as exc:
        return None, f"the built module does not load: {exc}"
    return mod, None


def fastloader_status():
    """(the loader module or None, why it is None or None), built once."""
    if "status" not in _state:
        mod, why = _load()
        if mod is None:
            warnings.warn(f"native JPEG loader unavailable ({why}): decoding with PIL")
        _state["status"] = (mod, why)
    return _state["status"]


def get_fastloader():
    """The loader module (`load_images(paths, resolution)`), or None."""
    return fastloader_status()[0]
