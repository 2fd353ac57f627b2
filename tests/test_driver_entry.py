"""Driver entry points: the multi-device dry run and bench.py.

The dryrun parent decides to respawn onto virtual CPU devices without
touching a backend (on a GPU host that would claim the card for nothing).
bench.py prints exactly one parseable JSON line naming the device, refuses
to run without a GPU unless the CPU is pinned explicitly, and exits
non-zero whenever a stage failed or wedged.
"""

import json
import os
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent


def _run(code: str, env_extra: dict, timeout: float) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env.pop("_THESIA_DRYRUN_CHILD", None)
    env.update(env_extra)
    return subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        timeout=timeout,
        cwd=REPO,
        env=env,
    )


def test_dryrun_parent_respawns_without_backend_touch():
    """The respawn decision must not initialize any backend: under a
    non-cpu platform pin (a GPU host), dryrun_multichip must choose to
    respawn onto virtual CPUs from config alone.  jax.devices is stubbed to
    raise, so a parent that counted devices first would fail here."""
    code = (
        "import sys, jax\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import __graft_entry__ as g\n"
        "calls = []\n"
        "g._respawn_with_virtual_devices = lambda n: calls.append(n)\n"
        "def _boom(*a, **k):\n"
        "    raise AssertionError('parent touched the backend')\n"
        "jax.devices = _boom\n"
        "g.dryrun_multichip(8)\n"
        "assert calls == [8], calls\n"
        "print('PARENT_NO_BACKEND_OK', jax.config.jax_platforms)\n"
    )
    p = _run(code, {"JAX_PLATFORMS": "cuda"}, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "PARENT_NO_BACKEND_OK" in p.stdout


def test_dryrun_child_runs_in_process_on_cpu():
    """A process already pinned to cpu (tests, the respawned child) runs
    the dryrun body in-process — no recursive respawn."""
    code = (
        "import sys, jax\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "import __graft_entry__ as g\n"
        "def _no(*a, **k): raise AssertionError('respawned from a cpu child')\n"
        "g._respawn_with_virtual_devices = _no\n"
        "g.dryrun_multichip(2)\n"
        "print('CHILD_IN_PROCESS_OK')\n"
    )
    p = _run(
        code,
        {
            "JAX_PLATFORMS": "cpu",
            "_THESIA_DRYRUN_CHILD": "1",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
            "THESIA_PRECOMPILE": "0",
        },
        timeout=600,
    )
    assert p.returncode == 0, (p.stderr[-3000:], p.stdout[-500:])
    assert "CHILD_IN_PROCESS_OK" in p.stdout


def _last_json_line(stdout: str) -> dict:
    lines = [l for l in stdout.strip().splitlines() if l.strip()]
    assert lines, "bench printed nothing"
    # contract: ONE JSON line; it is the only stdout line bench prints
    payload = [l for l in lines if l.startswith("{")]
    assert len(payload) == 1, f"expected exactly one JSON line, got: {lines}"
    return json.loads(payload[0])


def test_bench_emits_json_when_backend_dead():
    """Without a GPU and without an explicit CPU pin, bench.py measures
    nothing: it prints one error line naming the backend it found and exits
    non-zero (no CPU numbers stand in for device numbers)."""
    env = {"JAX_PLATFORMS": "cpu", "THESIA_BENCH_FAST": "1"}
    p = _run(
        "import os; os.environ.pop('THESIA_BENCH_BACKEND', None); "
        "import runpy; runpy.run_path('bench.py', run_name='__main__')",
        env,
        timeout=300,
    )
    assert p.returncode != 0, p.stdout[-2000:]
    doc = _last_json_line(p.stdout)
    assert doc["platform"] == "cpu" and doc["device_count"] >= 1
    assert "no GPU" in doc["error"], doc
    assert "value" not in doc


def test_run_stage_timeout_and_fault_paths():
    """_run_stage degrades a wedged or raising stage to (None, reason)
    without blocking the run."""
    import bench

    t0 = time.perf_counter()
    v, e = bench._run_stage("wedge", lambda: time.sleep(60), budget_s=0.5)
    assert v is None and e.startswith("timeout>")
    assert time.perf_counter() - t0 < 10

    def boom():
        raise ValueError("kaput")

    v, e = bench._run_stage("boom", boom, budget_s=5)
    assert v is None and "kaput" in e

    v, e = bench._run_stage("ok", lambda: 42, budget_s=5)
    assert v == 42 and e is None

    os.environ["THESIA_BENCH_FAULT"] = "inj"
    try:
        v, e = bench._run_stage("inj", lambda: 42, budget_s=5)
        assert v is None and "injected fault" in e
    finally:
        os.environ.pop("THESIA_BENCH_FAULT", None)


def test_bench_single_stage_fault_preserves_all_other_fields():
    """Killing any single stage still yields a parsed artifact containing
    every other stage's numbers, and a non-zero exit.  Full bench runs on
    the pinned CPU backend in fast mode with a fault injected into the
    multitrack stage; every non-multitrack field must carry a real
    value."""
    p = _run(
        "import runpy; runpy.run_path('bench.py', run_name='__main__')",
        {
            "THESIA_BENCH_BACKEND": "cpu",
            "THESIA_BENCH_FAST": "1",
            "THESIA_BENCH_FAULT": "multitrack",
            "THESIA_BENCH_TOTAL_BUDGET": "560",
            "THESIA_BENCH_STAGE_BUDGET": "120",
            "THESIA_PRECOMPILE": "0",
        },
        timeout=590,
    )
    assert p.returncode == 1, p.stderr[-3000:]
    doc = _last_json_line(p.stdout)
    assert doc["platform"] == "cpu" and doc["card"].startswith("none")
    assert doc["multitrack_mixed_sr_x_realtime"] is None
    assert "multitrack" in doc.get("error", ""), doc
    missing = [
        k
        for k, val in doc.items()
        if val is None and k != "multitrack_mixed_sr_x_realtime"
    ]
    assert not missing, (missing, doc)


def test_run_stage_timeout_restores_env_and_flags_taint():
    """An abandoned stage never runs its finally-block env restore: the
    harness must restore the snapshot itself and flag the artifact (review
    finding — a wedged cold_shape left THESIA_PRECOMPILE=1 for every later
    'clean' timing)."""
    import bench

    bench._ABANDONED.clear()
    os.environ["THESIA_STAGE_ENV_PROBE"] = "before"

    def wedge():
        os.environ["THESIA_STAGE_ENV_PROBE"] = "polluted"
        os.environ["THESIA_STAGE_ENV_NEW"] = "zombie"
        time.sleep(60)

    try:
        v, e = bench._run_stage("wedge_env", wedge, budget_s=0.8)
        assert v is None and "abandoned" in e
        assert os.environ["THESIA_STAGE_ENV_PROBE"] == "before"
        assert "THESIA_STAGE_ENV_NEW" not in os.environ
        assert "wedge_env" in bench._ABANDONED
    finally:
        bench._ABANDONED.clear()
        os.environ.pop("THESIA_STAGE_ENV_PROBE", None)
        os.environ.pop("THESIA_STAGE_ENV_NEW", None)
