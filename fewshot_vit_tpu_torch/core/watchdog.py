"""Hang-proof re-exec guard for the card-timing entry points (counterpart:
``fewshot_vit_tpu/core/watchdog.py``).

A CUDA context can wedge: a kernel that never returns, or a CUDA API call
blocked on a card in a bad state, holds the process inside a C call where
neither a SIGALRM handler nor a watchdog thread can run. Only an external
kill ends it. A hung timing run is worse than a failed one, so a timing
entry point re-execs itself as a killable child and fails loudly when the
child outlives its budget.
"""

from __future__ import annotations

import os
import subprocess
import sys

# the port's own key: a JAX child and a port child never take each other's mark
_ENV_KEY = "_FEWSHOT_TORCH_WATCHDOG_CHILD"


def watchdog_reexec(timeout_s: float = 1500.0) -> None:
    """Re-exec the current script (same argv) as a killable child and exit
    with its status; inside the child (marked in the environment) return at
    once.

    Call FIRST in ``main()``, before anything touches the card.
    ``timeout_s`` bounds the child's wall clock; on expiry the child is
    killed and the parent exits 2 with a message naming the watchdog.
    """
    if os.environ.get(_ENV_KEY) == "1":
        return
    env = dict(os.environ)
    env[_ENV_KEY] = "1"
    # `python -m pkg.mod` sets argv[0] to the module FILE; re-execing that
    # path would drop the package context and break relative imports, so the
    # -m form is rebuilt from __main__'s spec
    import __main__

    spec = getattr(__main__, "__spec__", None)
    if spec is not None and spec.name:
        cmd = [sys.executable, "-m", spec.name] + sys.argv[1:]
    else:
        cmd = [sys.executable] + sys.argv
    try:
        proc = subprocess.run(cmd, env=env, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        print(f"watchdog: no result after {timeout_s:.0f}s "
              "(a hung kernel or a wedged CUDA context?)", file=sys.stderr, flush=True)
        sys.exit(2)
    sys.exit(proc.returncode)
