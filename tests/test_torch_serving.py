"""The port's serving stack over real HTTP sockets on the CPU, after
``tests/test_serving.py`` and ``tests/test_serving_cb.py``: the port's
controller and model worker (registration, ``list_models``,
``worker_get_status``, a stream through the controller with an image, the
image-count error), two concurrent continuous-batching streams whose final
text equals the JAX worker's on the same checkpoint, the web server's
``log_vote`` and ``pop_last_exchange``, and a worker on a card that is not
there."""

import base64
import json
import os
import socket
import sys
import threading
from io import BytesIO

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from util import make_tiny_checkpoint  # noqa: E402

requests = pytest.importorskip("requests")

TIMEOUT = 120
MODEL = "cambrian-tiny"


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _stop(server):
    server.shutdown()
    server.server_close()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_serve_ckpt"))
    make_tiny_checkpoint(path)
    return path


@pytest.fixture(scope="module")
def stack(ckpt):
    from cambrian_tpu_torch.serve.controller import Controller
    from cambrian_tpu_torch.serve.controller import serve as serve_controller
    from cambrian_tpu_torch.serve.model_worker import ModelWorker
    from cambrian_tpu_torch.serve.model_worker import serve as serve_worker

    cport, wport = _free_port(), _free_port()
    controller = Controller("shortest_queue")
    cserver = serve_controller(controller, "localhost", cport)
    controller_addr = f"http://localhost:{cport}"
    worker_addr = f"http://localhost:{wport}"
    worker = ModelWorker(controller_addr, worker_addr, "w0", ckpt, None, MODEL,
                         device="cpu", limit_model_concurrency=2, register=True)
    wserver = serve_worker(worker, "localhost", wport)
    yield controller_addr, worker_addr, worker
    _stop(wserver)
    _stop(cserver)


def _chunks(response):
    return [json.loads(c.decode()) for c in
            response.iter_lines(decode_unicode=False, delimiter=b"\0") if c]


def test_register_and_list_models(stack):
    controller_addr, worker_addr, _ = stack
    r = requests.post(controller_addr + "/list_models", json={}, timeout=TIMEOUT)
    assert r.json()["models"] == [MODEL]
    r = requests.post(controller_addr + "/get_worker_address", json={"model": MODEL},
                      timeout=TIMEOUT)
    assert r.json()["address"] == worker_addr
    r = requests.post(controller_addr + "/get_worker_address", json={"model": "missing"},
                      timeout=TIMEOUT)
    assert r.json()["address"] == ""


def test_worker_status(stack):
    controller_addr, worker_addr, _ = stack
    status = requests.post(worker_addr + "/worker_get_status", json={},
                           timeout=TIMEOUT).json()
    assert status["model_names"] == [MODEL] and status["queue_length"] == 0
    total = requests.post(controller_addr + "/worker_get_status", json={},
                          timeout=TIMEOUT).json()
    assert total["model_names"] == [MODEL]


def test_generate_stream_through_controller_with_an_image(stack):
    from PIL import Image

    controller_addr, _, worker = stack
    buf = BytesIO()
    Image.new("RGB", (48, 32), (10, 200, 100)).save(buf, format="PNG")
    prompt = "describe the <image> please"
    r = requests.post(controller_addr + "/worker_generate_stream", json={
        "model": MODEL, "prompt": prompt, "images": [base64.b64encode(buf.getvalue()).decode()],
        "temperature": 0.0, "top_p": 1.0, "max_new_tokens": 5,
    }, stream=True, timeout=TIMEOUT)
    datas = _chunks(r)
    assert datas and all(d["error_code"] == 0 for d in datas), datas
    assert datas[-1]["text"].startswith(prompt)
    assert len(datas[-1]["text"]) >= len(datas[0]["text"])
    # the request went through the towers: the engine recorded their encode
    assert worker.model.engine.last_timings["encode_ms"] > 0


def test_generate_stream_image_count_mismatch(stack):
    _, worker_addr, _ = stack
    r = requests.post(worker_addr + "/worker_generate_stream", json={
        "model": MODEL, "prompt": "no image marker here", "images": ["aGVsbG8="],
        "temperature": 0.0, "max_new_tokens": 4,
    }, stream=True, timeout=TIMEOUT)
    assert _chunks(r)[-1]["error_code"] == 1      # a graceful error, not a crash


# -- continuous batching ------------------------------------------------------------

PROMPTS = ["a cat sat on", "hello world what is"]


@pytest.fixture(scope="module")
def cb_worker(ckpt):
    from cambrian_tpu_torch.models.builder import load_pretrained_model
    from cambrian_tpu_torch.serve.model_worker import ModelWorker
    from cambrian_tpu_torch.serve.model_worker import serve as serve_worker

    bundle = load_pretrained_model(ckpt, device="cpu", dtype=torch.float32)
    port = _free_port()
    worker = ModelWorker("http://unused", f"http://localhost:{port}", "w0", ckpt, None, MODEL,
                         device="cpu", register=False, model_bundle=bundle,
                         continuous_batching=True, num_slots=2)
    server = serve_worker(worker, "localhost", port)
    yield f"http://localhost:{port}", worker
    _stop(server)
    worker.close()


def _payload(prompt):
    return {"model": MODEL, "prompt": prompt, "temperature": 0.0, "max_new_tokens": 5}


def test_concurrent_continuous_streams_match_jax_worker(cb_worker, ckpt):
    import jax.numpy as jnp

    from cambrian_tpu.models.builder import load_pretrained_model as j_load
    from cambrian_tpu.serve.model_worker import ModelWorker as JModelWorker

    addr, worker = cb_worker
    out = {}

    def stream(i, prompt):
        r = requests.post(addr + "/worker_generate_stream", json=_payload(prompt),
                          stream=True, timeout=TIMEOUT)
        out[i] = _chunks(r)

    threads = [threading.Thread(target=stream, args=(i, p)) for i, p in enumerate(PROMPTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert set(out) == {0, 1}

    jworker = JModelWorker("http://unused", "http://unused", "j0", ckpt, None, MODEL,
                           register=False, model_bundle=j_load(ckpt, dtype=jnp.float32),
                           continuous_batching=True, num_slots=2)
    for i, prompt in enumerate(PROMPTS):
        chunks = out[i]
        assert chunks and all(c["error_code"] == 0 for c in chunks), chunks
        assert chunks[-1]["text"].startswith(prompt)
        want = [json.loads(c[:-1]) for c in jworker.generate_stream_gate(_payload(prompt))]
        # one chunk a token, the same cumulative text at each
        assert [c["text"] for c in chunks] == [w["text"] for w in want]
    assert worker.cb_engine.slot_request == [None, None]


def test_worker_on_cuda_without_a_card_raises(ckpt, monkeypatch):
    from cambrian_tpu_torch.serve.model_worker import ModelWorker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelWorker("http://unused", "http://unused", "w1", ckpt, None, MODEL, device="cuda",
                    register=False)


# -- the web server's helpers ---------------------------------------------------------

def test_vote_log_format(tmp_path, monkeypatch):
    """upvote/downvote/flag records in the reference's conv-log schema
    (tstamp/type/model/state(+ip)), one JSON object a line."""
    from cambrian_tpu_torch.serve import gradio_web_server as gws

    monkeypatch.setattr(gws, "LOGDIR", str(tmp_path))
    state = {"history": [["hi <image>", "a reply"]]}
    gws.log_vote("upvote", MODEL, state, ip="1.2.3.4")
    gws.log_vote("downvote", MODEL, state)
    gws.log_vote("flag", MODEL, state)
    with open(gws.get_conv_log_filename()) as f:
        rows = [json.loads(line) for line in f]
    assert [r["type"] for r in rows] == ["upvote", "downvote", "flag"]
    assert all(r["model"] == MODEL and r["state"] == state for r in rows)
    assert rows[0]["ip"] == "1.2.3.4" and "ip" not in rows[1]
    assert all(isinstance(r["tstamp"], float) for r in rows)


def test_regenerate_pops_last_exchange():
    from cambrian_tpu_torch.serve.gradio_web_server import pop_last_exchange

    assert pop_last_exchange([["q1", "a1"], ["q2", "a2"]]) == ([["q1", "a1"]], "q2")
    assert pop_last_exchange([]) == ([], "")
