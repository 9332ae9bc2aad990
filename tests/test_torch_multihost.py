"""The port's multi-node rendezvous, ``parallel/multihost.py::initialize_multihost``
(twin of ``tests/test_multihost.py``).

Two fresh jax-free processes join one gloo process group at a coordinator,
from explicit arguments or from torchrun's environment, see a world of 2
and all-gather across the process boundary.  A run with no arguments and
no such environment is a no-op; a half-given rendezvous raises.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch.distributed as dist

from scalerl_torch.parallel import initialize_multihost

REPO = Path(__file__).resolve().parent.parent
TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")

_WORKER = textwrap.dedent(
    """
    import sys

    sys.path.insert(0, {repo!r})
    import torch
    import torch.distributed as dist

    from scalerl_torch.parallel.multihost import initialize_multihost

    ran = initialize_multihost(**{kwargs!r}, device="cpu")
    assert ran, "distributed init did not run"
    assert dist.get_world_size() == 2 and dist.get_rank() == {pid}, dist.get_world_size()
    assert dist.get_backend() == "gloo", dist.get_backend()
    parts = [torch.zeros(1) for _ in range(2)]
    dist.all_gather(parts, torch.tensor([float(dist.get_rank() + 1)]))
    total = torch.cat(parts).tolist()
    assert total == [1.0, 2.0], total
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "scalerl_tpu"))
    assert not bad, bad
    dist.destroy_process_group()
    print("proc {pid} OK", flush=True)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("mode", ["arguments", "torchrun_env"])
def test_two_process_rendezvous(mode):
    # bounded by the communicate(timeout=...) below, no pytest-timeout needed
    port = _free_port()
    procs = []
    for pid in range(2):
        env = {k: v for k, v in os.environ.items()
               if k not in TORCHRUN_ENV + ("PYTHONPATH",)}
        if mode == "arguments":
            kwargs = dict(coordinator_address=f"127.0.0.1:{port}", num_processes=2,
                          process_id=pid)
        else:
            kwargs = {}
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                       RANK=str(pid), LOCAL_RANK=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER.format(repo=str(REPO), kwargs=kwargs, pid=pid)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid} OK" in out


def test_single_host_without_arguments_is_a_no_op(monkeypatch):
    for name in TORCHRUN_ENV:
        monkeypatch.delenv(name, raising=False)
    assert initialize_multihost() is False
    assert initialize_multihost(device="cpu") is False
    assert not dist.is_initialized()


def test_a_half_given_rendezvous_raises(monkeypatch):
    for name in TORCHRUN_ENV:
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="process_id"):
        initialize_multihost(coordinator_address="127.0.0.1:1", num_processes=2, device="cpu")
    assert not dist.is_initialized()
