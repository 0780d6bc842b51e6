"""ctypes bindings and on-demand build of the exact C++ EMD solver
(counterpart: ``fewshot_vit_tpu/native/emd.py``).

``emd_solver.cpp`` beside this file is a copy of the JAX package's
transportation simplex (MODI). It is host code in both packages, not a
kernel: ``solver: exact`` sends each batch of EMD problems to the host in
float64 and brings the flows back (``heads/deepemd.py::exact_flows``).

The library is built with ``g++ -O2 -shared -fPIC`` into
``build/native/libemd.so`` at the root of the checkout (listed in
``.gitignore``), at first use or when the source is newer than the library,
under a unique temporary name renamed into place, so concurrent builds never
load a half-written file. Nothing is built into, or loaded from, the JAX
package's directory.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "emd_solver.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
LIB = BUILD_DIR / "libemd.so"
GXX_FLAGS = ("-O2", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def _build() -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libemd.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SRC.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIB)


def get_lib() -> ctypes.CDLL:
    """The loaded ``libemd.so``, built first if it is missing or stale."""
    global _lib
    with _LOCK:
        if _lib is None:
            if not LIB.exists() or LIB.stat().st_mtime < SRC.stat().st_mtime:
                _build()
            lib = ctypes.CDLL(str(LIB))
            d = ctypes.POINTER(ctypes.c_double)
            lib.emd_exact_batch.argtypes = [d, d, d, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_int, d, d]
            lib.emd_exact_batch.restype = ctypes.c_int
            _lib = lib
        return _lib


def emd_exact(cost: np.ndarray, w1: np.ndarray, w2: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact EMD flows for a batch of problems: cost (B, N1, N2), w1 (B, N1),
    w2 (B, N2), float64 on the host. ``w2`` is rescaled to ``w1``'s sum
    first (rounding between the two sides breaks the simplex). Returns
    (flows (B, N1, N2), objective values (B,))."""
    cost = np.ascontiguousarray(cost, np.float64)
    w1 = np.ascontiguousarray(w1, np.float64)
    w2 = np.ascontiguousarray(w2, np.float64)
    b, n1, n2 = cost.shape
    w2 = w2 * (w1.sum(-1, keepdims=True) / w2.sum(-1, keepdims=True))
    flows = np.zeros_like(cost)
    costs = np.zeros(b, np.float64)
    d = ctypes.POINTER(ctypes.c_double)
    rc = get_lib().emd_exact_batch(
        cost.ctypes.data_as(d), w1.ctypes.data_as(d), w2.ctypes.data_as(d),
        b, n1, n2, flows.ctypes.data_as(d), costs.ctypes.data_as(d),
    )
    if rc != 0:
        raise RuntimeError(f"emd_exact_batch failed with code {rc}")
    return flows, costs
