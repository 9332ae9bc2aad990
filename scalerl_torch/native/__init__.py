"""The port's host-side native library: the lock-free shared-memory slot
ring (``scalerl_torch/csrc/shm_ring.cpp``), built with g++ at first use."""

from scalerl_torch.native.build import load_ring_lib  # noqa: F401
