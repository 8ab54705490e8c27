"""SIGTERM/exit device release of the port (dist_dqn_tpu_torch/utils/
device_cleanup.py), twin of JAX's ``tests/test_device_cleanup.py``.

A CPU stand-in for a run holding the card: a process with a world-size-1
``gloo`` group and live tensors is SIGTERM'd mid-run. The handler must
release (destroy the group, empty the allocator's cache where CUDA is
up), chain the handler installed before it, and end the process with
``128 + SIGTERM``; a fresh process must then build a group at once. The
watchdog abort's order holds too: its emergency hooks run before the
SIGTERM that releases the card.
"""
import os
import signal
import subprocess
import sys
import textwrap
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_GROUP = textwrap.dedent("""
    import datetime, socket
    import torch
    import torch.distributed as dist
    s = socket.socket(); s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]; s.close()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
""")

_CHILD = textwrap.dedent("""
    import signal, sys, time
    sys.path.insert(0, %r)
""" % REPO) + _GROUP + textwrap.dedent("""
    def earlier(signum, frame):
        print("EARLIER_HANDLER group_alive=%d" % dist.is_initialized(),
              flush=True)
        import os
        os._exit(128 + signum)
    signal.signal(signal.SIGTERM, earlier)
    from dist_dqn_tpu_torch.utils.device_cleanup import install
    install(log_fn=print)
    bufs = [torch.ones((256, 256)) * i for i in range(4)]  # live tensors
    dist.all_reduce(bufs[1])
    print("CHILD_READY", flush=True)
    time.sleep(60)
""")


def _wait_ready(proc):
    deadline = time.time() + 120
    line = ""
    while time.time() < deadline:
        line = proc.stdout.readline()
        if "CHILD_READY" in line or not line:
            break
    assert "CHILD_READY" in line, line


def test_sigterm_releases_device_buffers(tmp_path):
    script = tmp_path / "holder.py"
    script.write_text(_CHILD)
    proc = subprocess.Popen([sys.executable, str(script)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, cwd=REPO)
    try:
        _wait_ready(proc)
        t0 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        out = proc.stdout.read()
        rc = proc.wait(timeout=30)
        exit_s = time.monotonic() - t0
    finally:
        proc.kill()
    assert rc == 128 + signal.SIGTERM, (rc, out)
    # Released first (the group destroyed), then the earlier handler ran.
    assert "device buffers released" in out, out
    assert out.index("device buffers released") < out.index(
        "EARLIER_HANDLER group_alive=0"), out
    assert exit_s < 30
    # The backend survives for fresh processes: a new group forms at once.
    check = subprocess.run(
        [sys.executable, "-c", _GROUP + "print(dist.get_world_size())"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert check.returncode == 0 and check.stdout.strip() == "1", \
        check.stderr


def test_install_idempotent_and_atexit_path(tmp_path):
    script = tmp_path / "exiting.py"
    script.write_text(textwrap.dedent("""
        import sys
        sys.path.insert(0, %r)
        import torch
        from dist_dqn_tpu_torch.utils.device_cleanup import install
        install(log_fn=print)
        install(log_fn=print)  # second call must be a no-op
        x = torch.ones((8,))
        print("NORMAL_EXIT", flush=True)
    """ % REPO))
    proc = subprocess.run([sys.executable, str(script)],
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NORMAL_EXIT" in proc.stdout
    # atexit hook ran exactly once (idempotent install).
    assert proc.stdout.count("device buffers released") == 1


def test_watchdog_abort_runs_emergency_hooks_before_the_release(tmp_path):
    """The abort path the port's watchdog takes on a stall: emergency
    hooks first, then SIGTERM to itself, whose handler releases the card
    — the release never races a hook still copying the learner."""
    script = tmp_path / "abort.py"
    script.write_text(textwrap.dedent("""
        import os, signal, sys, time
        sys.path.insert(0, %r)
        from dist_dqn_tpu_torch.telemetry import watchdog
        from dist_dqn_tpu_torch.utils.device_cleanup import install
        install(log_fn=print)
        def hook():
            time.sleep(0.2)
            print("HOOK_DONE", flush=True)
        watchdog.register_emergency_hook("test.copy", hook)
        watchdog.run_emergency_hooks(timeout_s=10.0, log_fn=print)
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(30)
    """ % REPO))
    proc = subprocess.run([sys.executable, str(script)],
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO)
    out = proc.stdout
    assert proc.returncode == 128 + signal.SIGTERM, out + proc.stderr
    assert out.index("HOOK_DONE") < out.index("device buffers released")
