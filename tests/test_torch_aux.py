"""The port's auxiliaries: ``core/watchdog.py`` (the cases of
``tests/test_aux.py::TestWatchdog`` against the port's module) and
``--profile-dir`` (``train/runner.py::profile_epoch``, wrapped around epoch 2
of the pretrain trainer, as in JAX)."""

import contextlib
import json
import os
import subprocess
import sys
import time

from fewshot_vit_tpu_torch.core import watchdog
from fewshot_vit_tpu_torch.train import pretrain, runner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, **kw):
    return subprocess.run([sys.executable] + args, capture_output=True, text=True, **kw)


def test_watchdog_timeout_kills_child_and_exits_2(tmp_path):
    script = tmp_path / "hang.py"
    script.write_text(
        "import sys, time\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from fewshot_vit_tpu_torch.core.watchdog import watchdog_reexec\n"
        "watchdog_reexec(timeout_s=2)\n"
        "time.sleep(60)\n")
    t0 = time.perf_counter()
    out = _run([str(script)], timeout=30)
    assert out.returncode == 2
    assert "watchdog" in out.stderr
    assert time.perf_counter() - t0 < 20


def test_watchdog_child_runs_once_and_propagates_status(tmp_path):
    marker = tmp_path / "runs.txt"
    script = tmp_path / "ok.py"
    script.write_text(
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from fewshot_vit_tpu_torch.core.watchdog import watchdog_reexec\n"
        "watchdog_reexec(timeout_s=30)\n"
        f"open({str(marker)!r}, 'a').write('x')\n"
        "sys.exit(7)\n")
    out = _run([str(script)], timeout=60)
    assert out.returncode == 7          # the child's status passes through
    assert marker.read_text() == "x"    # the body ran exactly once


def test_watchdog_reexec_keeps_the_module_launch(tmp_path):
    """``python -m pkg.mod`` must re-exec with -m (argv[0] is the module FILE;
    running it as a script would break relative imports)."""
    pkg = tmp_path / "wdpkg"
    (pkg / "sub").mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "helper.py").write_text("VALUE = 42\n")
    (pkg / "sub" / "__init__.py").write_text("")
    (pkg / "sub" / "tool.py").write_text(
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from fewshot_vit_tpu_torch.core.watchdog import watchdog_reexec\n"
        "from .. import helper\n"
        "watchdog_reexec(timeout_s=30)\n"
        "print('OK', helper.VALUE)\n")
    env = dict(os.environ, PYTHONPATH=str(tmp_path) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = _run(["-m", "wdpkg.sub.tool"], timeout=60, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert "OK 42" in out.stdout


def test_watchdog_marks_its_child_with_a_key_of_its_own():
    """A JAX child's mark does not stop the port's guard, and the other way round."""
    from fewshot_vit_tpu.core import watchdog as j_watchdog

    assert watchdog._ENV_KEY != j_watchdog._ENV_KEY


def test_kernels_bench_calls_the_watchdog_first():
    """The port's timing entry point guards itself, as JAX's ``bench.py`` does."""
    import ast

    tree = ast.parse(open(os.path.join(ROOT, "fewshot_vit_tpu_torch", "kernels", "bench.py")).read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    first = main.body[0].value
    assert isinstance(first, ast.Call) and first.func.id == "watchdog_reexec"


def test_profile_epoch_is_a_nullcontext_unless_epoch_2_and_a_directory(tmp_path):
    def args(d):
        return runner.parse_args("t", ["--config", str(cfg)] + (["--profile-dir", d] if d else []))[1]

    cfg = tmp_path / "c.yaml"
    cfg.write_text("train_dataset: synthetic\n")
    assert args(None).profile_dir is None
    for a, epoch in ((args(None), 2), (args(str(tmp_path / "p")), 1),
                     (args(str(tmp_path / "p")), 3)):
        assert isinstance(runner.profile_epoch(a, epoch), contextlib.nullcontext)
    assert not isinstance(runner.profile_epoch(args(str(tmp_path / "p")), 2),
                          contextlib.nullcontext)
    assert not (tmp_path / "p").exists()  # nothing is written until the context runs


def test_pretrain_cli_writes_the_epoch_2_trace(tmp_path):
    from .test_torch_pretrain import CLI_CONFIG

    cfg = tmp_path / "c.yaml"
    cfg.write_text(CLI_CONFIG % (2, "adamw", 0, ""))
    prof = tmp_path / "prof"
    pretrain.main(*runner.parse_args("t", [
        "--config", str(cfg), "--save-root", str(tmp_path / "save"), "--name", "pre",
        "--device", "cpu", "--profile-dir", str(prof)]))
    assert sorted(os.listdir(prof)) == ["epoch2.trace.json"]
    events = json.loads((prof / "epoch2.trace.json").read_text())["traceEvents"]
    assert any(ev.get("cat") == "cpu_op" for ev in events)  # the CPU's ops; the card's kernels
    # are checked by chip_smoke.py
