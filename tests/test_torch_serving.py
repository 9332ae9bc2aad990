"""Parity and behaviour of the port's inference plane
(``scalerl_torch/serving/{server,client}.py``) and the serving trainer.

- The port's ``InferenceServer`` against the JAX package's on the same
  requests at a small LSTM ``AtariNet`` with converted weights: logits and
  cores within 1e-5 (float32), and equal actions with the JAX server's
  Gumbel draws injected, over flushes at two buckets with carried cores;
- one ``_device_put`` and one ``_device_get`` a flush, counted
  (tests/test_serving.py:279), a generation pushed during a flush does not
  retag it, the staleness gauge, shedding over ``max_pending``;
- the client: round trip and generation tags, local fallback and the raise
  without one, reconnect over sockets, re-probe out of degraded mode;
- a few learn steps of ``HostActorLearnerTrainer(actor_mode="serving")``
  on the CPU: finite losses, the staleness gauge set, no fallback, one
  copy each way a flush; and ``examples/train_impala_torch.py --actor-mode
  serving`` printing the SLO line.

Every wait on a pipe, socket or thread has its own timeout.
"""

import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from scalerl_torch import config as tconfig
from scalerl_torch.agents.impala import ImpalaAgent
from scalerl_torch.envs.gym_env import make_vect_envs
from scalerl_torch.fleet.transport import connect_socket
from scalerl_torch.runtime import telemetry
from scalerl_torch.serving import (
    InferenceServer,
    RemotePolicyClient,
    ServingConfig,
    ServingRequest,
    ServingUnavailable,
    local_pair,
)
from scalerl_torch.serving import server as tserver
from scalerl_torch.trainer import actor_learner as tal
from scalerl_tpu.agents import impala as jimpala
from scalerl_tpu.serving import InferenceServer as JServer
from scalerl_tpu.serving import ServingConfig as JConfig
from scalerl_tpu.serving import ServingRequest as JRequest
from scalerl_tpu.serving import local_pair as jlocal_pair

torch.set_num_threads(1)
WAIT_S = 20.0


def _mlp_agent():
    args = tconfig.ImpalaArguments(use_lstm=False, hidden_size=32, max_timesteps=0)
    return ImpalaAgent(args, (4,), 2, device="cpu")


def _payload(lanes=2, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(lanes, 4)).astype(np.float32),
        "last_action": np.zeros(lanes, np.int32),
        "reward": np.zeros(lanes, np.float32),
        "done": np.ones(lanes, bool),
        "core": (),
    }


def _act(client, p):
    return client.act(p["obs"], p["last_action"], p["reward"], p["done"], p["core"])


def _served(agent, **cfg):
    server = InferenceServer(agent, ServingConfig(**{"max_batch": 8, "max_wait_s": 0.002, **cfg}))
    server.start()
    c_end, s_end = local_pair()
    server.add_connection(s_end)
    return server, c_end


def _free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---------------------------------------------------------------------------
# the server against the JAX server


def _lstm_requests(rng, lanes, A, obs_shape, core_size, conn_j, conn_t, first_id):
    """The same requests for both servers: pixels, actions, rewards, done
    flags and a carried (random) two-layer core a request."""
    jreqs, treqs = [], []
    for i, n in enumerate(lanes):
        payload = {
            "obs": rng.integers(0, 255, (n,) + obs_shape).astype(np.uint8),
            "last_action": rng.integers(0, A, n).astype(np.int32),
            "reward": rng.normal(size=n).astype(np.float32),
            "done": rng.uniform(size=n) < 0.3,
            "core": tuple((rng.normal(size=(n, core_size)).astype(np.float32),
                           rng.normal(size=(n, core_size)).astype(np.float32)) for _ in range(2)),
        }
        jreqs.append(JRequest(conn=conn_j, req_id=first_id + i, lanes=n, payload=payload))
        treqs.append(ServingRequest(conn=conn_t, req_id=first_id + i, lanes=n, payload=payload))
    return jreqs, treqs


def test_server_matches_the_jax_server_with_injected_draws():
    A, obs_shape = 5, (24, 24, 4)
    jargs, targs = H.args_pair(use_lstm=True, rollout_length=4, batch_size=2)
    jagent = jimpala.ImpalaAgent(jargs, obs_shape=obs_shape, num_actions=A)
    tagent = ImpalaAgent(targs, obs_shape, A, device="cpu")
    tagent.state = H.state_to_torch(jagent.state)
    cfg = dict(max_batch=4, max_wait_s=0.002, seed=3)
    jserver, tserv = JServer(jagent, JConfig(**cfg)), InferenceServer(tagent, ServingConfig(**cfg))
    jc, js = jlocal_pair()
    tc, ts = local_pair()
    jserver.hub.add_connection(js)
    tserv.hub.add_connection(ts)
    core_size = jagent.initial_state(1)[0][0].shape[-1]
    # the JAX server splits its key once a flush and draws categorical over
    # the bucket's padded logits: argmax(logits + gumbel(sub, [bucket, A]))
    key = jax.random.PRNGKey(cfg["seed"])
    draws = []

    def jax_gumbel(logits):
        return torch.from_numpy(np.array(draws.pop(0)))

    tserv._gumbel = jax_gumbel
    rng = np.random.default_rng(0)
    try:
        for flush, lanes in enumerate(([2], [1, 2], [3])):  # buckets 2, 4, 4
            bucket = tserver.bucket_for(sum(lanes), tserv.batcher.buckets)
            key, sub = jax.random.split(key)
            draws.append(jax.random.gumbel(sub, (bucket, A), jnp.float32))
            jreqs, treqs = _lstm_requests(rng, lanes, A, obs_shape, core_size, js, ts, 10 * flush)
            jserver._flush(jreqs)
            tserv._flush(treqs)
            for _ in lanes:
                jr, tr = jc.recv(timeout=WAIT_S), tc.recv(timeout=WAIT_S)
                assert jr["req"] == tr["req"] and tr["gen"] == jr["gen"] == 0
                np.testing.assert_allclose(tr["logits"], jr["logits"], atol=1e-5, rtol=1e-5)
                for (jcc, jh), (tcc, th) in zip(jr["core"], tr["core"]):
                    np.testing.assert_allclose(tcc, jcc, atol=1e-5, rtol=1e-5)
                    np.testing.assert_allclose(th, jh, atol=1e-5, rtol=1e-5)
                np.testing.assert_array_equal(tr["action"], np.asarray(jr["action"]))
                assert tr["action"].dtype == np.int32
        assert tserv._warm_buckets == jserver._warm_buckets == {2, 4}
        assert tserv.flushes == tserv.device_puts == tserv.device_gets == 3
    finally:
        jserver.hub.close()
        tserv.hub.close()


def test_server_core_init_and_health_replies_match_jax():
    A, obs_shape = 3, (24, 24, 4)
    jargs, targs = H.args_pair(use_lstm=True)
    jagent = jimpala.ImpalaAgent(jargs, obs_shape=obs_shape, num_actions=A)
    tagent = ImpalaAgent(targs, obs_shape, A, device="cpu")
    jserver, tserv = JServer(jagent, JConfig()), InferenceServer(tagent, ServingConfig())
    jc, js = jlocal_pair()
    tc, ts = local_pair()
    try:
        for server, s_end, msg in ((jserver, js, "core_init"), (tserv, ts, "core_init")):
            server._admit(s_end, {"kind": msg, "req": 5, "batch": 3})
        jr, tr = jc.recv(timeout=WAIT_S), tc.recv(timeout=WAIT_S)
        assert tr["kind"] == jr["kind"] == "core_init" and tr["req"] == 5
        assert [(c.shape, c.dtype, h.shape) for c, h in tr["core"]] == \
            [(np.asarray(c).shape, np.asarray(c).dtype, np.asarray(h).shape) for c, h in jr["core"]]
        assert all(not c.any() and not h.any() for c, h in tr["core"])
        for server, s_end in ((jserver, js), (tserv, ts)):
            server._admit(s_end, {"kind": "health", "req": "h"})
        jr, tr = jc.recv(timeout=WAIT_S), tc.recv(timeout=WAIT_S)
        assert set(tr) == set(jr) and tr["kind"] == "health_result" and tr["pending"] == 0
    finally:
        jserver.hub.close()
        tserv.hub.close()


# ---------------------------------------------------------------------------
# the server alone


def test_server_round_trip_and_generation_tag():
    agent = _mlp_agent()
    server, c_end = _served(agent)
    client = RemotePolicyClient(conn=c_end)
    try:
        assert client.initial_state(2) == ()
        action, logits, core = _act(client, _payload())
        assert action.shape == (2,) and action.dtype == np.int32 and logits.shape == (2, 2)
        assert core == () and client.generation == 0
        assert server.push_params(agent.get_weights()) == 1
        _act(client, _payload())
        assert client.generation == 1
        _, local_logits, _ = agent.act(*(_payload()[k] for k in
                                         ("obs", "last_action", "reward", "done")))
        np.testing.assert_allclose(_act(client, _payload())[1], local_logits, atol=1e-6)
    finally:
        client.close()
        server.stop()


def test_one_put_and_one_get_per_flush(monkeypatch):
    counts = {"put": 0, "get": 0}
    put, get = tserver._device_put, tserver._device_get

    def counting_put(*a, **k):
        counts["put"] += 1
        return put(*a, **k)

    def counting_get(*a, **k):
        counts["get"] += 1
        return get(*a, **k)

    monkeypatch.setattr(tserver, "_device_put", counting_put)
    monkeypatch.setattr(tserver, "_device_get", counting_get)
    server = InferenceServer(_mlp_agent(), ServingConfig(max_batch=8), guard_warm_flushes=True)
    c_end, s_end = local_pair()
    server.hub.add_connection(s_end)
    try:
        for i, lanes in enumerate((2, 2, 3, 2, 5)):
            server._flush([ServingRequest(conn=s_end, req_id=i, lanes=lanes,
                                          payload=_payload(lanes, seed=i))])
            assert c_end.recv(timeout=WAIT_S)["req"] == i
        assert counts == {"put": 5, "get": 5}
        assert server.flushes == server.device_puts == server.device_gets == 5
        assert server._warm_buckets == {2, 4, 8}
    finally:
        server.hub.close()


def test_a_push_during_a_flush_keeps_the_served_generation(monkeypatch):
    agent = _mlp_agent()
    server = InferenceServer(agent, ServingConfig(max_batch=8))
    c_end, s_end = local_pair()
    server.hub.add_connection(s_end)
    get = tserver._device_get

    def get_with_a_push(*a, **k):
        server.push_params(agent.get_weights())  # lands mid-flush
        return get(*a, **k)

    monkeypatch.setattr(tserver, "_device_get", get_with_a_push)
    try:
        server._flush([ServingRequest(conn=s_end, req_id=7, lanes=2, payload=_payload())])
        reply = c_end.recv(timeout=WAIT_S)
        assert reply["req"] == 7 and reply["gen"] == 0 and server.generation == 1
    finally:
        server.hub.close()


def test_staleness_gauge_reports_learner_step_lag():
    agent = _mlp_agent()
    server = InferenceServer(agent, ServingConfig())
    try:
        for step in (10, 25, 40):
            server.push_params(agent.get_weights(), learner_step=step)
        reg = telemetry.get_registry()
        assert server.observe_staleness(1) == 30.0
        assert reg.gauge("serving.staleness").value == reg.gauge("staleness").value == 30.0
        assert reg.gauge("staleness_plane.serving").value == 30.0
        assert server.observe_staleness(3) == 0.0
    finally:
        server.hub.close()


def test_server_sheds_over_max_pending_and_replies_at_once():
    server, c_end = _served(_mlp_agent(), max_batch=1024, max_wait_s=60.0, max_pending=1)
    client = RemotePolicyClient(conn=c_end)
    try:
        p = _payload()
        first = client.act_async(p["obs"], p["last_action"], p["reward"], p["done"], ())
        deadline = time.monotonic() + WAIT_S
        while server.batcher.stats()["pending_requests"] < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        second = client.act_async(p["obs"], p["last_action"], p["reward"], p["done"], ())
        assert second.result(timeout=WAIT_S).get("shed") is True
        assert server.batcher.shed_total == 1 and not first.done()
    finally:
        client.close()
        server.stop()
    # stopping answered the request the batcher still held
    assert server.accounting() == {"admitted": 2, "answered": 1, "shed": 1, "errors": 0,
                                   "pending": 0, "balanced": True}


def test_many_threads_share_one_client_and_each_gets_its_own_reply():
    """The client's demux under contention: 16 threads (more than this
    machine's cores) act through ONE link with a short switch interval;
    every reply must carry the logits of the thread's own observations."""
    import sys
    import threading

    agent = _mlp_agent()
    server, c_end = _served(agent, max_batch=16)
    client = RemotePolicyClient(conn=c_end, request_timeout_s=WAIT_S)
    wrong, done = [], []

    def worker(k):
        rng = np.random.default_rng(k)
        for _ in range(15):
            p = _payload(lanes=1 + k % 3, seed=int(rng.integers(1 << 30)))
            _, logits, _ = _act(client, p)
            _, want, _ = agent.act(p["obs"], p["last_action"], p["reward"], p["done"], ())
            if not np.allclose(logits, want, atol=1e-6):
                wrong.append(k)
        done.append(k)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(k,), daemon=True) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
        client.close()
        server.stop()
    assert sorted(done) == list(range(16)) and not wrong
    assert server.accounting()["answered"] == 16 * 15 and server.accounting()["balanced"]


# ---------------------------------------------------------------------------
# the client


class _StubFallback:
    def initial_state(self, batch_size):
        return ()

    def act(self, obs, last_action, reward, done, core_state):
        B = np.asarray(obs).shape[0]
        return np.full(B, 9, np.int32), np.zeros((B, 2), np.float32), ()


def test_client_falls_back_to_local_on_server_loss():
    server, c_end = _served(_mlp_agent())
    client = RemotePolicyClient(conn=c_end, fallback=_StubFallback(), request_timeout_s=2.0,
                                max_attempts=3)
    fallbacks = telemetry.get_registry().counter("serving_client.fallbacks").value
    try:
        _act(client, _payload())
        server.stop()  # no reconnect factory for an in-process pipe
        action, _, _ = _act(client, _payload())
        assert client.fallen_back
        np.testing.assert_array_equal(action, np.full(2, 9, np.int32))
        assert telemetry.get_registry().counter("serving_client.fallbacks").value == fallbacks + 1
    finally:
        client.close()


def test_client_without_a_fallback_raises_on_server_loss():
    server, c_end = _served(_mlp_agent())
    client = RemotePolicyClient(conn=c_end, request_timeout_s=2.0, max_attempts=2)
    try:
        _act(client, _payload())
        server.stop()
        with pytest.raises(ServingUnavailable):
            _act(client, _payload())
    finally:
        client.close()


def test_client_reconnects_over_sockets():
    port = _free_port()
    server = InferenceServer(_mlp_agent(), ServingConfig(max_batch=8, max_wait_s=0.002))
    server.start(listen_port=port)
    client = RemotePolicyClient(
        connect=lambda: connect_socket("127.0.0.1", port, retries=5),
        request_timeout_s=5.0, reconnect_backoff_s=0.05, reconnect_backoff_cap_s=0.2,
        max_reconnects=10)
    try:
        _act(client, _payload())
        with server.hub._lock:
            conns = list(server.hub._conns)
        assert conns
        for c in conns:  # sever every link at the server; the accept loop stays
            server.hub.disconnect(c)
        action, _, _ = _act(client, _payload())
        assert action.shape == (2,) and client.reconnects_used >= 1 and not client.fallen_back
    finally:
        client.close()
        server.stop()


def test_fallen_back_client_reprobes_a_recovered_server():
    port = _free_port()
    agent = _mlp_agent()
    server = InferenceServer(agent, ServingConfig(max_batch=8, max_wait_s=0.002))
    server.start(listen_port=port)
    client = RemotePolicyClient(
        connect=lambda: connect_socket("127.0.0.1", port, retries=2),
        fallback=_StubFallback(), request_timeout_s=2.0, max_attempts=2, max_reconnects=1,
        reconnect_backoff_s=0.01, reconnect_backoff_cap_s=0.02, reprobe_backoff_s=0.05,
        reprobe_backoff_cap_s=0.2)
    try:
        _act(client, _payload())
        server.stop()
        deadline = time.monotonic() + WAIT_S
        while not client.fallen_back and time.monotonic() < deadline:
            _act(client, _payload())
        assert client.fallen_back
        np.testing.assert_array_equal(_act(client, _payload())[0], np.full(2, 9, np.int32))
        server = InferenceServer(agent, ServingConfig(max_batch=8, max_wait_s=0.002))
        server.start(listen_port=port)
        deadline = time.monotonic() + WAIT_S
        while client.fallen_back and time.monotonic() < deadline:
            _act(client, _payload())
            time.sleep(0.02)
        assert not client.fallen_back and client.reprobes_used >= 1
        assert np.all(_act(client, _payload())[0] < 2)  # the agent again, not the stub
    finally:
        client.close()
        server.stop()


def test_the_agent_as_fallback_takes_the_servers_host_core():
    """A serving trainer's fallback is its LSTM agent: after the server
    goes, the core the server last answered with (numpy) feeds the agent's
    act as it would a device core."""
    args = tconfig.ImpalaArguments(use_lstm=True, hidden_size=16, max_timesteps=0)
    agent = ImpalaAgent(args, (24, 24, 4), 3, device="cpu")
    server = InferenceServer(agent, ServingConfig(max_batch=4, max_wait_s=0.002))
    server.start()
    c_end, s_end = local_pair()
    server.add_connection(s_end)
    client = RemotePolicyClient(conn=c_end, fallback=agent, request_timeout_s=2.0)
    rng = np.random.default_rng(0)
    obs = rng.integers(0, 255, (2, 24, 24, 4)).astype(np.uint8)
    step = (obs, np.zeros(2, np.int32), np.zeros(2, np.float32), np.zeros(2, bool))
    try:
        _, _, core = client.act(*step, client.initial_state(2))
        assert all(isinstance(c, np.ndarray) for pair in core for c in pair)
        server.stop()
        _, logits, new_core = client.act(*step, core)
        assert client.fallen_back
        dev_core = tuple((torch.from_numpy(c), torch.from_numpy(h)) for c, h in core)
        _, want, want_core = agent.act(*step, dev_core)
        np.testing.assert_array_equal(logits, want)
        for (c, h), (wc, wh) in zip(new_core, want_core):
            assert torch.equal(c, wc) and torch.equal(h, wh)
    finally:
        client.close()
        server.stop()


def test_client_reads_a_device_core_back_before_the_wire():
    msg = RemotePolicyClient._act_msg(None, np.zeros((1, 4), np.float32), [0], [0.0], [True],
                                      ((torch.ones(1, 3), torch.zeros(1, 3)),))
    (c, h), = msg["core"]
    assert isinstance(c, np.ndarray) and c.tolist() == [[1.0, 1.0, 1.0]]


# ---------------------------------------------------------------------------
# the serving trainer


def _serving_args(tmp_path, **kw):
    base = dict(env_id="CartPole-v1", rollout_length=8, batch_size=4, num_actors=2, num_buffers=8,
                use_lstm=False, hidden_size=32, logger_backend="none", logger_frequency=64,
                work_dir=str(tmp_path), max_timesteps=0, telemetry_interval_s=0.0,
                save_model=False, actor_mode="serving", serve_max_batch=8,
                serve_max_wait_ms=2.0)
    base.update(kw)
    return tconfig.ImpalaArguments(**base)


def test_serving_trainer_takes_learn_steps_on_the_cpu(tmp_path):
    reg = telemetry.get_registry()
    fallbacks = reg.counter("serving_client.fallbacks").value
    reg.gauge("serving.staleness").set(-1.0)
    args = _serving_args(tmp_path)
    agent = ImpalaAgent(args, (4,), 2, device="cpu")
    fns = [(lambda i=i: make_vect_envs("CartPole-v1", num_envs=2, seed=i, async_envs=False))
           for i in range(2)]
    trainer = tal.HostActorLearnerTrainer(args, agent, fns)
    server = trainer.inference_server
    try:
        result = trainer.train(total_frames=256)
    finally:
        trainer.close()
    losses = [m["total_loss"] for _, kind, m in trainer.log_history if kind == "train"]
    assert result["env_frames"] >= 256 and losses and all(np.isfinite(losses))
    assert trainer.learn_steps > 0 and server.generation == trainer.learn_steps
    assert server.flushes > 0 and server.device_puts == server.device_gets == server.flushes
    acc = server.accounting()
    assert acc["balanced"] and acc["pending"] == 0 and acc["answered"] > 0
    assert all(not c.fallen_back for c in trainer._serving_clients)
    assert max(c.generation for c in trainer._serving_clients) > 0
    assert reg.counter("serving_client.fallbacks").value == fallbacks
    assert reg.gauge("serving.staleness").value >= 0.0
    slo = server.slo()
    assert slo["requests"] > 0 and slo["p99_ms"] >= slo["p50_ms"] >= 0.0
    assert not any(t.is_alive() for t in server._threads)


def test_serving_config_validation_matches_jax():
    from scalerl_tpu import config as jconfig

    for kw in (dict(actor_mode="nonsense"), dict(serve_max_batch=0),
               dict(serve_max_wait_ms=-1.0), dict(serve_max_pending=-1)):
        errs = []
        for cls in (jconfig.ImpalaArguments, tconfig.ImpalaArguments):
            with pytest.raises(ValueError) as e:
                cls(**kw).validate()
            errs.append(str(e.value))
        assert errs[0] == errs[1]
    args = tconfig.ImpalaArguments(serve_max_batch=16, serve_max_wait_ms=3.0, seed=4)
    cfg = ServingConfig.from_args(args)
    assert (cfg.max_batch, cfg.max_pending, cfg.seed) == (16, 256, 4)
    assert cfg.max_wait_s == pytest.approx(0.003)


def test_example_runs_the_serving_mode_on_the_host(tmp_path, capsys):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "examples" / "train_impala_torch.py"
    spec = importlib.util.spec_from_file_location("train_impala_torch_serving", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--device", "cpu", "--actor-mode", "serving", "--env-id", "CartPole-v1",
                    "--num-actors", "2", "--num-envs", "4", "--num-buffers", "8",
                    "--max-timesteps", "256", "--use-lstm", "false", "--hidden-size", "32",
                    "--rollout-length", "8", "--batch-size", "4", "--serve-max-batch", "8",
                    "--serve-max-wait-ms", "2", "--logger-backend", "none",
                    "--save-model", "false", "--telemetry-interval-s", "0",
                    "--work-dir", str(tmp_path)])
    assert out["trainer"].inference_server.flushes > 0
    assert "serving SLO:" in capsys.readouterr().out
