"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` into
its own shared library, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v -o _build/lib<name>-<hash>.so <name>.cu

The build runs at first CUDA use, from the sources in the package only, into
`mask3d_tpu_torch/_build/` (nvcc's temporary files too, in `_build/tmp/`).
The file name carries a hash of the source, so an edited kernel is rebuilt.
Nothing is built when a module is imported.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
KERNELS = ("masked_attention", "row_gather", "sparse_conv", "int8_conv",
           "lsap")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
# Compiler output (ptxas registers / shared memory / spills) per kernel.
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _nvcc_env() -> Dict[str, str]:
    """The environment of an nvcc run: its temporary files in the build
    directory, whatever TMPDIR the caller has."""
    tmp = BUILD_DIR / "tmp"
    tmp.mkdir(parents=True, exist_ok=True)
    return dict(os.environ, TMPDIR=str(tmp))


def _lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Iterable[str] = KERNELS) -> float:
    """Compile every named kernel that is not built yet, one `nvcc` per
    source, all started together. Returns the wall seconds it took."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    env = None
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        env = env or _nvcc_env()
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _libs[name] = lib
    return lib


def load_source(source) -> ctypes.CDLL:
    """A library built from a CUDA source outside `csrc/` (an earlier
    kernel, for `tune_attention.py --old`), into `_build/` under a hash of
    the source and flags."""
    source = Path(source)
    flags = list(NVCC_FLAGS)
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()
                            ).hexdigest()[:12]
    out = BUILD_DIR / f"lib{source.stem}-{digest}.so"
    key = str(out)
    if key not in _libs:
        if not out.exists():
            BUILD_DIR.mkdir(exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *flags, "-o", str(tmp), str(source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=_nvcc_env())
            build_logs[str(source)] = proc.stdout
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {source}:\n"
                                   f"{proc.stdout}")
            os.replace(tmp, out)
        _libs[key] = ctypes.CDLL(key)
    return _libs[key]


_plain_on_cuda = False


@contextlib.contextmanager
def plain_versions():
    """Within the block the train path's kernel wrappers (attention, row
    gather, sparse conv, the LSAP) run their plain PyTorch versions on
    CUDA tensors too and count no launch: the reference that
    `chip_smoke.py` and the card tests hold a whole model's kernel path
    against. Nothing else enters it."""
    global _plain_on_cuda
    prev, _plain_on_cuda = _plain_on_cuda, True
    try:
        yield
    finally:
        _plain_on_cuda = prev


def use_kernel(t, what: str) -> bool:
    """Whether a wrapper launches its kernel on tensor `t`: on a CUDA
    tensor yes (outside `plain_versions`), on a CPU tensor no (the plain
    version); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return not _plain_on_cuda


def check(err: int, what: str):
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def call(fn, device, what: str, *args):
    """`fn(*args, stream)` with PyTorch's current stream on the CUDA
    `device` (made the current device for the call where it is not), then
    `check`. Reads the raw stream handle, which costs the host less than
    building a `torch.cuda.Stream`."""
    import torch

    index = device.index
    current = torch.cuda.current_device()
    if index is None or index == current:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(current))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    check(err, what)
