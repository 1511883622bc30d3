"""The port's stall watchdog and restart supervisor: the cases of
tests/test_watchdog.py against ``awr_tpu_torch``.  The stall is a sleep;
the exit path runs in a real subprocess, because the watchdog ends the
process with ``os._exit``.  Every timing margin is several seconds wide,
since the suite shares the machine with other workers."""

import os
import subprocess
import sys
import threading
import time

from awr_tpu_torch.config import resnet_config
from awr_tpu_torch.data.synthetic import SyntheticHandDataset
from awr_tpu_torch.training.supervise import supervise
from awr_tpu_torch.training.trainer import Trainer
from awr_tpu_torch.training.watchdog import EXIT_STALLED, Watchdog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=REPO + os.pathsep
           + os.environ.get("PYTHONPATH", ""))


# ------------------------------------------------------------ watchdog
def test_watchdog_quiet_while_beating():
    fired = []
    with Watchdog(3.0, exit_fn=fired.append) as wd:
        for _ in range(10):
            time.sleep(0.1)
            wd.beat()
    assert not fired


def test_watchdog_fires_on_silence_and_reports():
    fired = threading.Event()
    msgs = []
    wd = Watchdog(0.3, on_stall=msgs.append, name="unit",
                  exit_fn=lambda code: (msgs.append(code), fired.set()))
    wd.start()
    try:
        assert fired.wait(10.0), "watchdog never fired"
    finally:
        wd.stop()
    assert EXIT_STALLED in msgs
    assert any("WATCHDOG[unit]" in m for m in msgs if isinstance(m, str))


def test_watchdog_rejects_bad_timeout():
    try:
        Watchdog(0)
    except ValueError:
        pass
    else:
        raise AssertionError("timeout_s=0 accepted")


def test_watchdog_exits_process_for_real():
    code = (
        "import time\n"
        "from awr_tpu_torch.training.watchdog import Watchdog\n"
        "wd = Watchdog(0.5, name='e2e').start()\n"
        "wd.beat()\n"
        "time.sleep(60)\n"  # the wedged call
        "print('unreachable')\n"
    )
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO, env=ENV)
    assert p.returncode == EXIT_STALLED, (p.returncode, p.stderr)
    assert "WATCHDOG[e2e]" in p.stderr
    assert "unreachable" not in p.stdout


# ----------------------------------------------------------- supervisor
def test_supervise_restarts_on_stall_then_succeeds():
    codes = iter([EXIT_STALLED, EXIT_STALLED, 0])
    ran = []
    rc = supervise(["cmd"], max_restarts=3, backoff_s=0,
                   run_fn=lambda c: (ran.append(list(c)),
                                     next(codes))[1], log=lambda m: None)
    assert rc == 0
    assert len(ran) == 3


def test_supervise_does_not_retry_crashes_by_default():
    calls = []
    rc = supervise(["cmd"], max_restarts=3, backoff_s=0,
                   run_fn=lambda c: (calls.append(1), 1)[1],
                   log=lambda m: None)
    assert rc == 1 and len(calls) == 1
    codes = iter([1, 0])
    rc = supervise(["cmd"], max_restarts=3, restart_on="any",
                   backoff_s=0, run_fn=lambda c: next(codes),
                   log=lambda m: None)
    assert rc == 0


def test_supervise_exhausts_restart_budget():
    rc = supervise(["cmd"], max_restarts=2, backoff_s=0,
                   run_fn=lambda c: EXIT_STALLED, log=lambda m: None)
    assert rc == EXIT_STALLED


def test_supervise_cli_roundtrip(tmp_path):
    """The first attempt stalls (its marker file is absent), the restart
    succeeds."""
    marker = tmp_path / "ran_once"
    script = tmp_path / "child.py"
    script.write_text(
        "import os, sys\n"
        f"m = {str(marker)!r}\n"
        "if os.path.exists(m):\n"
        "    sys.exit(0)\n"
        "open(m, 'w').close()\n"
        "sys.exit(86)\n")
    p = subprocess.run(
        [sys.executable, "-m", "awr_tpu_torch.training.supervise",
         "--max-restarts", "2", "--backoff", "0", "--",
         sys.executable, str(script)],
        capture_output=True, text=True, timeout=120, cwd=REPO, env=ENV)
    assert p.returncode == 0, (p.returncode, p.stdout, p.stderr)
    assert "restarting" in p.stdout


# ---------------------------------------------------- Trainer integration
def small_cfg(**kw):
    return resnet_config(18, img_size=32, batch_size=4, vis_freq=0,
                         print_freq=1000, max_epoch=1, num_workers=2, **kw)


def test_trainer_watchdog_armed_and_disarmed(tmp_path, monkeypatch):
    """A healthy one-epoch run under a generous timeout completes and
    leaves the watchdog disarmed."""
    tr = Trainer(small_cfg(step_timeout_s=300.0),
                 SyntheticHandDataset(8, 14, 32, phase="train", seed=0,
                                      mode="raw"),
                 SyntheticHandDataset(4, 14, 32, phase="test", seed=1,
                                      mode="raw"),
                 workdir=str(tmp_path), device="cpu")
    seen = {}
    impl = Trainer._train_impl

    def spy(self):
        seen["armed"] = self._watchdog is not None
        return impl(self)

    monkeypatch.setattr(Trainer, "_train_impl", spy)
    tr.train()
    assert seen["armed"], "watchdog not armed despite step_timeout_s"
    assert tr._watchdog is None, "watchdog left armed after train()"
    tr.close()


def test_trainer_stall_kills_process(tmp_path):
    """A Trainer whose step stream stops beating exits 86, and the stall
    lands in its log."""
    code = (
        "import time\n"
        "from awr_tpu_torch.config import resnet_config\n"
        "from awr_tpu_torch.data.synthetic import SyntheticHandDataset\n"
        "from awr_tpu_torch.training.trainer import Trainer\n"
        "def hang(self):\n"
        "    self._beat()\n"
        "    time.sleep(120)\n"  # the wedged call
        "Trainer._train_impl = hang\n"
        "cfg = resnet_config(18, img_size=32, batch_size=4, vis_freq=0,\n"
        "                    max_epoch=1, step_timeout_s=1.0)\n"
        "train = SyntheticHandDataset(8, 14, 32, phase='train', seed=0,\n"
        "                             mode='raw')\n"
        f"tr = Trainer(cfg, train, workdir={str(tmp_path)!r},\n"
        "             device='cpu')\n"
        "tr.train()\n"
    )
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=REPO, env=ENV)
    assert p.returncode == EXIT_STALLED, (p.returncode, p.stderr[-2000:])
    logs = list(tmp_path.glob("*.log"))
    assert logs and any("WATCHDOG" in f.read_text() for f in logs)
