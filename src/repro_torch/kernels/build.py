"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each source under `src/repro_torch/csrc/` compiles on its own into a shared
library with a plain C interface (`nvcc -shared`, `sm_90a`), which takes a
few seconds per file against minutes for an extension that includes PyTorch's
headers. Libraries land in `build/repro_torch/` at the repository root (listed
in `.gitignore`), named by a digest of the source, the headers it includes
from `csrc/` and the flags, so a changed source or header never loads a
stale library. Building happens at first use — never at import
— so the CPU-only test run imports every module without a compiler.

`build_all` starts one nvcc per source at once and returns each build's
`-Xptxas -v` report (registers, shared memory, spills), which also stays
beside the library (`ptxas_report`); `load` returns the ctypes handle,
building first if needed, and `load_all` loads every library once. A
failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("quant_matmul", "paged_attention", "flash_attention", "topk_sim",
           "ssd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the port's "
            "kernels build only on a machine with the CUDA toolkit")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def source_files(name: str, csrc: Path = CSRC) -> List[Path]:
    """`csrc/<name>.cu` and every header it includes from `csrc/` by a
    quoted `#include`, transitively, in the order first reached."""
    files: List[Path] = []
    todo = [csrc / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in files:
            continue
        files.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = path.parent / inc.decode()
            if dep.exists():
                todo.append(dep)
    return files


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """Where the library of `csrc/<name>.cu` lives: named by a digest of the
    source, its headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files(name, csrc):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES,
              csrc: Path = CSRC) -> Dict[str, str]:
    """Compile every source not yet built, all nvcc processes at once.
    Returns {name: ptxas report} for the sources built by this call."""
    names = list(names)
    todo = [n for n in names if not library_path(n, csrc).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List = []
    for n in todo:
        out = library_path(n, csrc)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{n}.cu")]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    reports = {}
    for n, out, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{stderr}")
            continue
        os.replace(tmp, out)
        reports[n] = (stdout + stderr).strip()
        out.with_suffix(".ptxas").write_text(reports[n])
    if failed:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
    return reports


def ptxas_report(name: str) -> str:
    """The `-Xptxas -v` report of the built `csrc/<name>.cu`, kept beside
    the library; empty if it was not built here."""
    path = library_path(name).with_suffix(".ptxas")
    return path.read_text() if path.exists() else ""


def load(name: str, signatures: Dict[str, List],
         csrc: Path = CSRC) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use, with
    `argtypes` set from `signatures` ({function: [ctypes types]}) and every
    function returning its cudaError_t as an int. Another `csrc` directory
    (an older version of a source, to time against) builds beside it."""
    key = name if csrc is CSRC else f"{name}@{csrc}"
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is None:
            build_all([name], csrc)
            lib = ctypes.CDLL(str(library_path(name, csrc)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LIBS[key] = lib
        return lib


def load_all() -> None:
    """Build what is not built yet and load every library once, so a
    process finds out at start-up, not at its first launch, that a kernel
    cannot load (a worker process reports it in its ready reply)."""
    build_all()
    for name in SOURCES:
        ctypes.CDLL(str(library_path(name)))


def check(err: int, what: str):
    """Raise on a nonzero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")

