"""The port's replica front end (``serving/httpd.py``, a copy of the JAX
package's, over the port's engine) held to the JAX package.

* Without a socket: each endpoint's handler runs on an in-memory request
  against a port engine and against a JAX engine of the same
  configuration; the JSON bodies carry the same key sets (``/healthz``
  with its adapter, offload and mesh fields, ``/livez``, ``/readyz``
  ready and draining, ``/debug/requests``, ``/debug/trace``,
  ``/generate``, ``/migrate/export`` and ``/migrate/import`` in their
  stream and prefix forms) and the same status codes; ``/metrics`` is
  the Prometheus text exposition.
* The JSON error contract: a malformed body, a prompt past the slot,
  a token outside the vocabulary (400 ``bad_request``), an unknown route
  (404 ``not_found``), an unknown adapter (404 ``unknown_adapter``), a
  stdlib-generated error (``http_<code>``), and a full queue (503
  ``queue_full`` with an integer ``Retry-After``), each as JAX answers it.
* Over a real socket: concurrent ``POST /generate`` on an
  ``EngineServer`` returns ids token-identical to JAX ``generate`` (no
  tolerance), and the SSE stream's tokens equal the buffered answer.
"""
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import torch_port_mirror as mirror
from paddle_tpu import monitor as jax_monitor
from paddle_tpu.models import GPTModel as JaxGPT
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import LoRAAdapter as JaxLoRA
from paddle_tpu.serving import httpd as jax_httpd
from paddle_tpu_torch.serving import LoRAAdapter, httpd as port_httpd
from paddle_tpu_torch.serving.stream import parse_sse

torch.set_num_threads(1)

PROMPT = list(range(11, 31))
CFG = dict(num_slots=2, max_seq_len=64, kv_block_size=8, prefill_chunk=8,
           kv_host_mb=1)


@pytest.fixture(scope="module")
def tiny_gpt():
    paddle.seed(0)
    m = JaxGPT.from_config("tiny", dropout=0.0)
    m.eval()
    return m


@pytest.fixture(scope="module")
def engines(tiny_gpt):
    """A port and a JAX engine of one configuration (paged, chunked,
    the ragged path, a host tier, an adapter lane), loops running."""
    pe = mirror.port_engine(
        mirror.port_model(tiny_gpt), adapters={
            "a1": LoRAAdapter.random(4, 64, n_layers=2, seed=11,
                                     scale=0.5)}, **CFG)
    je = JaxEngine(tiny_gpt, attn_impl="ragged", adapters={
        "a1": JaxLoRA.random(4, 64, n_layers=2, seed=11, scale=0.5)},
        registry=jax_monitor.StatRegistry(), **CFG)
    pe.start()
    je.start()
    yield pe, je
    pe.stop()
    je.stop()


def _call(mod, engine, method, path, body=None, raw=None):
    """Run one request through ``mod._Handler`` bound to ``engine``, in
    memory.  Returns (status, headers dict, body bytes)."""
    cls = type("Bound", (mod._Handler,), {"engine": engine,
                                          "result_timeout": 30.0})
    h = cls.__new__(cls)
    data = raw if raw is not None else (
        b"" if body is None else json.dumps(body).encode())
    h.rfile = io.BytesIO(data)
    h.wfile = io.BytesIO()
    h.headers = {"Content-Length": str(len(data))}
    h.command, h.path = method, path
    h.request_version = "HTTP/1.1"
    h.requestline = f"{method} {path} HTTP/1.1"
    h.client_address = ("127.0.0.1", 0)
    h.close_connection = False
    if method == "GET":
        h.do_GET()
    elif method == "POST":
        h.do_POST()
    else:
        h.send_error(501, f"Unsupported method ({method!r})")
    head, _, payload = h.wfile.getvalue().partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    status = int(lines[0].split()[1])
    headers = dict(ln.split(": ", 1) for ln in lines[1:])
    return status, headers, payload


def _both(engines, method, path, body=None, raw=None):
    pe, je = engines
    p = _call(port_httpd, pe, method, path, body, raw)
    j = _call(jax_httpd, je, method, path, body, raw)
    return p, j


def _json(resp):
    return json.loads(resp[2])


@pytest.mark.parametrize("path", ["/healthz", "/livez", "/readyz",
                                  "/debug/requests", "/debug/trace",
                                  "/nope"])
def test_get_endpoints_key_sets_equal_jax(engines, path):
    p, j = _both(engines, "GET", path)
    assert p[0] == j[0]
    assert p[1]["Content-Type"] == j[1]["Content-Type"]
    pj, jj = _json(p), _json(j)
    assert sorted(pj) == sorted(jj)
    if path == "/healthz":
        assert pj["attn_impl"] == "ragged" and pj["adapters"] == ["a1"]
        assert pj["kv_dtype"] == jj["kv_dtype"] == "float32"
        assert pj["mesh_shape"] is None and pj["mp"] == 1
        assert pj["kv_host_capacity_mb"] == 1.0
    if path == "/debug/requests":
        assert sorted(pj["engine"]) == sorted(jj["engine"])
        assert sorted(pj["slots"][0]) == sorted(jj["slots"][0])


def test_readyz_draining_and_metrics(engines):
    pe, je = engines
    for e in engines:
        e._draining = True
    try:
        p, j = _both(engines, "GET", "/readyz")
    finally:
        for e in engines:
            e._draining = False
    assert p[0] == j[0] == 503
    assert _json(p) == _json(j) == {"status": "unavailable",
                                    "ready": False, "state": "draining",
                                    "reason": "draining"}
    p, j = _both(engines, "GET", "/metrics")
    assert p[0] == 200 and p[1]["Content-Type"] == j[1]["Content-Type"]
    assert b"serving_tokens_total" in p[2]


def test_generate_and_migrate_key_sets_equal_jax(engines, tiny_gpt):
    """``/generate``, ``/migrate/export`` (the submit-then-export body
    and the prefix body) and ``/migrate/import`` (stream and prefix
    payloads): same status, same keys; the exported wire payloads have
    the same keys, and each side's greedy ids equal JAX ``generate``."""
    want = tiny_gpt.generate(paddle.to_tensor(np.asarray([PROMPT],
                                                         np.int32)),
                             max_new_tokens=10,
                             compiled="fused").numpy()[0].tolist()
    body = {"prompt": PROMPT, "max_new_tokens": 10}
    p, j = _both(engines, "POST", "/generate", body)
    assert p[0] == j[0] == 200
    assert sorted(_json(p)) == sorted(_json(j))
    assert _json(p)["ids"] == _json(j)["ids"] == want
    p, j = _both(engines, "POST", "/migrate/export",
                 dict(body, min_tokens=3))
    assert p[0] == j[0] == 200
    pj, jj = _json(p), _json(j)
    assert sorted(pj) == sorted(jj)
    assert sorted(pj["payload"]) == sorted(jj["payload"])
    assert sorted(pj["payload"]["kv"]) == sorted(jj["payload"]["kv"])
    pi, ji = _both(engines, "POST", "/migrate/import",
                   raw=json.dumps(pj["payload"]).encode())
    assert pi[0] == ji[0] == 200
    assert _json(ji)["ids"] == want
    assert _json(pi)["ids"] == want
    # the JAX engine adopts the port's payload too (one wire format)
    jx = _call(jax_httpd, engines[1], "POST", "/migrate/import",
               raw=json.dumps(pj["payload"]).encode())
    assert jx[0] == 200 and _json(jx)["ids"] == want
    assert sorted(_json(pi)) == sorted(_json(jx))
    p, j = _both(engines, "POST", "/migrate/export",
                 {"prefix_only": True, "tokens": PROMPT})
    assert p[0] == j[0] == 200
    assert sorted(_json(p)["payload"]) == sorted(_json(j)["payload"])
    p, j = _both(engines, "POST", "/migrate/import",
                 raw=json.dumps(_json(p)["payload"]).encode())
    assert p[0] == j[0] == 200 and sorted(_json(p)) == sorted(_json(j))


@pytest.mark.parametrize("case", [
    ("POST", "/generate", b"{not json", 400, "bad_request"),
    ("POST", "/generate", json.dumps({"prompt": list(range(60)),
                                      "max_new_tokens": 10}).encode(),
     400, "bad_request"),
    ("POST", "/generate", json.dumps({"prompt": [1, 500]}).encode(),
     400, "bad_request"),
    ("POST", "/generate", json.dumps({"prompt": [1, 2],
                                      "adapter": "zz"}).encode(),
     404, "unknown_adapter"),
    ("POST", "/nope", b"{}", 404, "not_found"),
    ("PUT", "/generate", b"", 501, "http_501"),
    ("POST", "/migrate/import", json.dumps(
        {"request": {"prompt": [1, 2], "max_new_tokens": 2},
         "kv": {"n_blocks": 1, "block_size": 4, "num_heads": 4,
                "head_dim": 16, "n_layers": 2, "dtype": "float32",
                "data": None}}).encode(), 400, "bad_request"),
], ids=["bad_json", "too_long", "bad_token", "unknown_adapter",
        "no_route", "stdlib_error", "bad_payload"])
def test_json_error_contract_equals_jax(engines, case):
    method, path, raw, code, reason = case
    p, j = _both(engines, method, path, raw=raw)
    assert p[0] == j[0] == code
    assert p[1]["Content-Type"] == "application/json"
    assert _json(p)["reason"] == _json(j)["reason"] == reason
    assert sorted(_json(p)) == sorted(_json(j))


def test_queue_full_carries_retry_after(tiny_gpt):
    """A full queue sheds with 503 ``queue_full`` and an integer
    ``Retry-After`` (the engine's honest 1 s while its drain rate is
    unmeasured), as the JAX handler answers."""
    pe = mirror.port_engine(mirror.port_model(tiny_gpt), max_queue=1,
                            **dict(CFG, kv_host_mb=None))
    je = JaxEngine(tiny_gpt, max_queue=1, attn_impl="ragged",
                   registry=jax_monitor.StatRegistry(),
                   **dict(CFG, kv_host_mb=None))
    pe.submit(PROMPT, max_new_tokens=2)   # no loop: it stays queued
    je.submit(PROMPT, max_new_tokens=2)
    body = {"prompt": PROMPT, "max_new_tokens": 2}
    p = _call(port_httpd, pe, "POST", "/generate", body)
    j = _call(jax_httpd, je, "POST", "/generate", body)
    assert p[0] == j[0] == 503
    assert _json(p)["reason"] == _json(j)["reason"] == "queue_full"
    assert p[1]["Retry-After"] == j[1]["Retry-After"] == "1"


def _post(url, obj, timeout=60.0):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.headers, resp.read()


def test_socket_generate_and_sse_equal_jax_generate(tiny_gpt):
    """Four concurrent ``POST /generate`` over a real socket (four
    prompts on two slots: they queue and share ticks) return ids equal to
    JAX ``generate``; a ``"stream": true`` request's SSE tokens equal its
    buffered answer."""
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 128, (9,)).tolist() for _ in range(4)]
    want = tiny_gpt.generate(paddle.to_tensor(np.asarray(prompts,
                                                         np.int32)),
                             max_new_tokens=8,
                             compiled="fused").numpy().tolist()
    eng = mirror.port_engine(mirror.port_model(tiny_gpt),
                             **dict(CFG, kv_host_mb=None))
    with port_httpd.EngineServer(eng) as srv:
        got = [None] * len(prompts)

        def call(k):
            got[k] = json.loads(_post(srv.address + "/generate",
                                      {"prompt": prompts[k],
                                       "max_new_tokens": 8})[2])["ids"]

        threads = [threading.Thread(target=call, args=(k,))
                   for k in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert got == want
        req = urllib.request.Request(
            srv.address + "/generate",
            data=json.dumps({"prompt": prompts[0], "max_new_tokens": 8,
                             "stream": True}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.headers["Content-Type"] == "text/event-stream"
            events = list(parse_sse(line.decode() for line in resp))
        toks = [json.loads(d)["token"] for e, d in events if e == "token"]
        done = [json.loads(d) for e, d in events if e == "done"]
        assert toks == want[0][9:] and done[0]["ids"] == want[0]
        try:
            urllib.request.urlopen(srv.address + "/nope", timeout=10)
        except urllib.error.HTTPError as e:
            assert e.code == 404
            assert json.loads(e.read())["reason"] == "not_found"
