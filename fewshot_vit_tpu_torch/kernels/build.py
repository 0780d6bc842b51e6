"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/kernels/lib<name>.so`` at the root of the checkout (listed in
``.gitignore``), at first use or when the source is newer than the library.
No PyTorch headers are included, so a build takes seconds.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("mhsa", "sinkhorn", "window_attn", "layer_norm", "block_attn")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    # optimise the kernels of a source on every CPU at once: mhsa.cu holds 36
    # instantiations
    "-split-compile", "0",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin")
    return path


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _fresh(name: str) -> bool:
    lib = library_path(name)
    return lib.exists() and lib.stat().st_mtime >= (CSRC / f"{name}.cu").stat().st_mtime


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source whose library is missing or stale, one
    ``nvcc`` process per source, all started together. Returns the compiler's
    output (``-Xptxas -v``: registers, shared memory, spills) per built name;
    raises if any build fails."""
    stale = [n for n in names if not _fresh(n)]
    if not stale:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in stale:
        # unique temporary name, renamed into place: concurrent builds
        # never load a half-written library
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, library_path(name))
        else:
            tmp.unlink(missing_ok=True)
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib


def _kernel_name(symbol: str) -> str:
    """``mhsa_tc_kernel<7,3>`` out of the mangled name that ptxas prints."""
    for m in re.finditer(r"\d+", symbol):
        n = int(m.group())
        name = symbol[m.end():m.end() + n]
        if len(name) == n and name.endswith("_kernel"):
            rest = symbol[m.end() + n:]
            if not rest.startswith("I") or "Ev" not in rest:
                return name
            args = re.findall(r"Li(\d+)E|\d+(__nv_bfloat16)|(f)", rest[1:rest.index("Ev")])
            names = [i or bf16 or "float" for i, bf16, _ in args]
            return f"{name}<{','.join(names)}>"
    return symbol


def ptxas_summary(log: str) -> List[str]:
    """One line per kernel of a build's ``-Xptxas -v`` output: its name
    beside registers, barriers, static shared memory and any spills."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if "Function properties for" in line or "Compiling entry function" in line:
            found = re.search(r"'?(_Z\w+)'?", line)
            name = _kernel_name(found.group(1)) if found else line.split()[-1]
            spill = ""
        elif "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
            spill = "; " + line.strip()
        elif "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}{spill}")
    return out
