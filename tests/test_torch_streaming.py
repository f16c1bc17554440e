"""The port's streaming inference server and client against the JAX
package's, over the same bytes: each package's client on the other's
server gives the same predictions (float32: 1e-5 of their scale), the
hello is field for field the same, and short frames, oversize frames and
malformed frames meet the same answers.  Every socket has a timeout; every
server is stopped in a ``finally``."""

import jax
import numpy as np
import pytest
import torch

from distkeras_torch import Model as TModel, ModelSpec as TSpec
from distkeras_torch.bridge import params_from_jax
from distkeras_torch.runtime import networking as tnet, streaming as tstream
from distkeras_tpu.models.base import Model as JModel, ModelSpec as JSpec
from distkeras_tpu.runtime import networking as jnet, streaming as jstream

TOL_F32 = 1e-5
MAX_BATCH = 16
SPEC = dict(name="mlp", config={"hidden_sizes": (8,), "num_outputs": 3}, input_shape=(6,))


@pytest.fixture(scope="module")
def servers():
    """A JAX server and a port server (CPU) on the same weights."""
    jm = JModel.init(JSpec(**SPEC), seed=0)
    tspec = TSpec(**SPEC)
    tm = TModel(tspec, params_from_jax(jax.tree.map(np.asarray, jm.params), tspec, device="cpu"))
    started = []
    try:
        started.append(jstream.StreamingInferenceServer(jm, max_batch=MAX_BATCH).start())
        started.append(tstream.StreamingInferenceServer(tm, max_batch=MAX_BATCH,
                                                        device="cpu").start())
        yield {"jax": started[0], "port": started[1], "model": tm}
    finally:
        for s in started:
            s.stop()


CLIENTS = {"jax": jstream, "port": tstream}


def _rows(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 6)).astype(np.float32)


@pytest.mark.parametrize("client,server", [("jax", "port"), ("port", "jax"), ("port", "port")])
def test_clients_and_servers_cross(servers, client, server):
    model = servers["model"]
    with CLIENTS[client].StreamingClient("127.0.0.1", servers[server].port, timeout=30) as c:
        assert c.max_batch == MAX_BATCH and c.output_shape == (3,)
        for b in (1, 5, MAX_BATCH, 11):          # short frames pad, one connection
            x = _rows(b, seed=b)
            got = c.predict(x)
            want = model.apply(torch.from_numpy(x)).numpy()
            assert got.shape == (b, 3) and got.dtype == np.float32
            np.testing.assert_allclose(got, want, atol=TOL_F32 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("client", sorted(CLIENTS))
def test_stream_predict_flushes_the_last_partial_batch(servers, client):
    x = _rows(2 * MAX_BATCH + 3, seed=7)
    seen = []
    for rows, preds in CLIENTS[client].stream_predict("127.0.0.1", servers["port"].port,
                                                       iter(x), micro_batch=MAX_BATCH):
        assert len(rows) == len(preds)
        seen.append(preds)
    assert [len(p) for p in seen] == [MAX_BATCH, MAX_BATCH, 3]
    want = servers["model"].apply(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.concatenate(seen), want, atol=TOL_F32 * np.abs(want).max())


def _hello(port):
    sock = jnet.connect("127.0.0.1", port, timeout=30)
    try:
        return jnet.recv_json(sock), sock
    except BaseException:
        sock.close()
        raise


def test_hello_is_the_same_field_for_field(servers):
    jhello, js = _hello(servers["jax"].port)
    thello, ts = _hello(servers["port"].port)
    js.close()
    ts.close()
    assert thello == jhello
    assert list(thello) == list(jhello)
    assert thello == {"streaming_predictor": 1, "row_shape": [6], "dtype": "<f4",
                      "max_batch": MAX_BATCH, "output_shape": [3], "output_dtype": "<f4"}


BAD_FRAMES = {
    "oversize": (tnet.ACTION_COMMIT, lambda: [_rows(MAX_BATCH + 1)],
                 f"batch {MAX_BATCH + 1} outside 1..{MAX_BATCH}"),
    "partial_row": (tnet.ACTION_COMMIT, lambda: [np.zeros(7, np.float32)],
                    "frame size 7 not a multiple of row size 6"),
    "wrong_action": (tnet.ACTION_PULL, lambda: [_rows(2)], "expected one feature frame"),
}


@pytest.mark.parametrize("server", ["jax", "port"])
@pytest.mark.parametrize("bad", sorted(BAD_FRAMES))
def test_bad_frames_meet_the_same_error(servers, server, bad):
    """The server answers one JSON error and closes the connection (the
    client refuses an oversize batch before sending, so the frame is sent
    raw here)."""
    action, arrays, error = BAD_FRAMES[bad]
    _, sock = _hello(servers[server].port)
    try:
        tnet.send_tensors(sock, action, arrays())
        assert tnet.recv_json(sock) == {"ok": False, "error": error}
        assert sock.recv(1) == b""                                # closed
    finally:
        sock.close()


def test_client_refuses_what_the_server_would(servers):
    with tstream.StreamingClient("127.0.0.1", servers["jax"].port, timeout=30) as c:
        with pytest.raises(ValueError, match="outside 1..16"):
            c.predict(_rows(MAX_BATCH + 1))
        with pytest.raises(ValueError, match="rows of shape"):
            c.predict(np.zeros((2, 5), np.float32))


def test_bf16_model_answers_float32():
    spec = TSpec(name="mlp", config={"hidden_sizes": (8,), "num_outputs": 3,
                                     "compute_dtype": "bfloat16"}, input_shape=(6,))
    model = TModel.init(spec, seed=0, device="cpu")
    server = tstream.StreamingInferenceServer(model, max_batch=4, device="cpu").start()
    try:
        with jstream.StreamingClient("127.0.0.1", server.port, timeout=30) as c:
            got = c.predict(_rows(3))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, model.apply(torch.from_numpy(_rows(3))).numpy())
    finally:
        server.stop()


def test_json_frames_are_the_jax_bytes():
    import socket

    msg = {"streaming_predictor": 1, "row_shape": [6], "dtype": "<f4", "é": [1.5, None]}
    got = {}
    for name, mod in (("jax", jnet), ("port", tnet)):
        a, b = socket.socketpair()
        try:
            b.settimeout(10)
            mod.send_json(a, msg)
            got[name] = b.recv(1 << 16)
            a.sendall(got[name])
            assert tnet.recv_json(b) == msg
        finally:
            a.close()
            b.close()
    assert got["port"] == got["jax"]
