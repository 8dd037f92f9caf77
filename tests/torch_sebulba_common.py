"""What the Sebulba tests of the PyTorch port share: the reference smoke's tiny
overrides, and subprocess runs of either package's entries, each in a session of its
own whose whole process group is killed if it outlasts its timeout (the launcher's
children stay in its group). Every child gets two torch threads."""

import json
import os
import signal
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Tuple

from tests.test_distributed.test_sebulba_smoke import PPO_OVERRIDES, SAC_OVERRIDES  # noqa: F401  (the reference smoke's)

REPO = Path(__file__).resolve().parents[1]
# the port's runs: on the CPU; no logger where a test reads nothing of it (its TensorBoard
# import alone takes seconds in every learner process)
PORT_CPU = ["device=cpu"]
QUIET_LOG = ["metric.log_level=0"]
# tests/test_distributed/test_actor_kill.py's run with learning starting at once and 256
# iterations an actor instead of 32: the port's actors step in ~1 ms on the CPU, so with
# the reference's 8 steps of prefill an actor that connects after the kill fills the
# kill window with blocks that take no gradient step, and in 32 iterations the other
# actor can be done before the kill
KILL_SAC = [
    "exp=sac_decoupled", "env=continuous_dummy", "algo.mlp_keys.encoder=[state]", "algo.hidden_size=8",
    "algo.per_rank_batch_size=8", "algo.learning_starts=0", "algo.replay_ratio=1.0", "algo.total_steps=1024",
    "algo.run_test=False", "buffer.size=512", "dry_run=False", "env.num_envs=2", "env.sync_env=True",
    "env.capture_video=False", "checkpoint.every=256", "checkpoint.save_last=True", "metric.log_every=32",
    "buffer.memmap=False", "distributed.num_actors=2", "distributed.connect_timeout_s=60",
    "distributed.respawn_backoff_s=0.2", "chaos.kill_actor_at_step=24", "chaos.kill_actor_index=0",
]


# a ``sitecustomize.py`` that cuts every socket's send and receive buffers to 16 KB in the
# processes that find it on their path: messages then outgrow the buffers as they do on a
# host whose TCP buffers do not grow
SMALL_SOCKET_BUFFERS = """import socket
def _small(sock):
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 16384)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 16384)
_connect, _listen, _accept = socket.socket.connect, socket.socket.listen, socket.socket.accept
def connect(self, address):
    _small(self)
    return _connect(self, address)
def listen(self, *args):
    _small(self)
    return _listen(self, *args)
def accept(self):
    conn, address = _accept(self)
    _small(conn)
    return conn, address
socket.socket.connect, socket.socket.listen, socket.socket.accept = connect, listen, accept
"""


def child_env(**extra) -> Dict[str, str]:
    env = {k: v for k, v in os.environ.items() if not k.startswith("SHEEPRL_TPU_")}
    env.update(OMP_NUM_THREADS="2", MKL_NUM_THREADS="2", SHEEPRL_TPU_QUIET="1")
    env.update({k: str(v) for k, v in extra.items()})
    return env


def jax_env(**extra) -> Dict[str, str]:
    return child_env(JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=2", **extra)


class Run:
    """``python -m <module> <overrides>`` started at once; ``wait`` ends it."""

    def __init__(self, module: str, overrides: List[str], env: Dict[str, str]):
        self.out = tempfile.TemporaryFile(mode="w+")
        self.cmd = [sys.executable, "-m", module, *overrides]
        self.proc = subprocess.Popen(self.cmd, cwd=REPO, env=env, stdout=self.out, stderr=subprocess.STDOUT, text=True,
                                     start_new_session=True)

    def output(self) -> str:
        self.out.seek(0)
        return self.out.read()

    def wait(self, timeout: float) -> Tuple[int, str]:
        """The exit code and the output; kills the process group if the run outlasts
        ``timeout``, and then raises."""
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()
            raise AssertionError(f"{' '.join(self.cmd[2:4])} outlasted {timeout} s:\n{self.output()[-4000:]}")
        finally:
            try:  # whatever of the group is left (a child of a crashed launcher)
                os.killpg(self.proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
        return rc, self.output()


def run_ok(runs: List[Run], timeout: float) -> List[str]:
    """Wait for ``runs`` (started side by side), each to exit 0; their outputs."""
    outs = []
    for run in runs:
        rc, out = run.wait(timeout)
        assert rc == 0, f"{' '.join(run.cmd[2:4])} exited {rc}:\n{out[-4000:]}"
        outs.append(out)
    return outs


def summary(path: Path) -> dict:
    return json.loads(Path(path).read_text())
