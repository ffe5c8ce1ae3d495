"""The port's HTTP server (`paths_tpu_torch.cli.serve`) on the CPU, against
the JAX package's server over the same model directory and store.

Every route answers with the same status and payload shape; prediction rows
carry the same slide ids, and hazards and risks agree to the serving tests'
1e-5 (f32 on the CPU, different summation order). The counters of
`/metrics` count the same requests and errors.
"""
import http.client
import json
import threading

import jax
import numpy as np
import pytest

from paths_tpu.cli.serve import make_server as j_make_server
from paths_tpu.data.synthetic import make_synthetic_store
from paths_tpu.models.recursive import recursive_init
from paths_tpu.serve import ServingSession as JSession
from paths_tpu.train.state import save_state
from test_torch_models import small_configs

from paths_tpu_torch.cli.serve import main, make_server
from paths_tpu_torch.serve import ServingSession

TOL = 1e-5


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_http")
    jcfg, _ = small_configs(pos_encoding_mode="2d")
    jcfg.preprocess_dir = str(tmp / "store")
    ids = make_synthetic_store(jcfg.preprocess_dir, jcfg, num_slides=6,
                               base_hw=(3, 4), seed=5)
    d = str(tmp / "model")
    jcfg.save(d)
    save_state(d, recursive_init(jax.random.PRNGKey(0), jcfg), None,
               {"epoch": 1})
    return (d, sorted(ids), JSession(d, batch_size=2, cache_batches=0),
            ServingSession(d, batch_size=2, device="cpu"))


class _Running:
    """A server serving in a thread, and one client connection to it."""

    def __init__(self, server):
        self.server = server
        threading.Thread(target=server.serve_forever, daemon=True).start()
        host, port = server.server_address[:2]
        self.addr = (host, port)
        self.conn = http.client.HTTPConnection(host, port, timeout=60)

    def call(self, method, path, body=None):
        self.conn.request(method, path,
                          body=None if body is None else json.dumps(body))
        r = self.conn.getresponse()
        return r.status, json.loads(r.read())

    def close(self):
        self.conn.close()
        self.server.shutdown()
        self.server.server_close()


def test_routes_match_jax(sessions):
    _, ids, jsess, tsess = sessions
    calls = [("GET", "/healthz", None), ("GET", "/slides", None),
             ("POST", "/predict", {"slide_ids": ids[:3]}),
             ("POST", "/predict", {"slide_ids": ["nope"]}),
             ("POST", "/predict", {}), ("POST", "/predict", {"slide_ids": []}),
             ("POST", "/predict", {"slide_ids": [1, 2]}),
             ("POST", "/predict", ["not-a-dict"]),
             ("POST", "/predict", "just-a-string"),
             ("POST", "/nope", {"slide_ids": ids[:1]}),
             ("GET", "/nope", None), ("GET", "/metrics", None)]
    answers = {}
    for name, server in (("jax", j_make_server(jsess, port=0)),
                         ("torch", make_server(tsess, port=0))):
        run = _Running(server)
        try:
            answers[name] = [run.call(*c) for c in calls]
        finally:
            run.close()
    for c, (js, jp), (ts, tp) in zip(calls, answers["jax"], answers["torch"]):
        assert ts == js, c
        if c[1] == "/healthz":       # session info: the port's adds device
            assert tp["ok"] is jp["ok"] is True
        else:
            assert sorted(tp) == sorted(jp), c
    health = answers["torch"][0][1]
    assert health["ok"] and health["task"] == "survival"
    assert health["device"] == "cpu" and health["num_slides"] == len(ids)
    assert answers["torch"][1][1]["slide_ids"] == ids
    got, want = answers["torch"][2][1], answers["jax"][2][1]
    assert [r["slide_id"] for r in got["predictions"]] == ids[:3]
    for a, b in zip(got["predictions"], want["predictions"]):
        assert a["slide_id"] == b["slide_id"]
        np.testing.assert_allclose(a["hazards"], b["hazards"], atol=TOL, rtol=0)
        np.testing.assert_allclose(a["risk"], b["risk"], atol=4 * TOL, rtol=0)
    jm, tm = answers["jax"][-1][1], answers["torch"][-1][1]
    for key in ("requests", "errors", "slides_predicted"):
        assert tm[key] == jm[key], key
    assert tm["requests"] == 11 and tm["errors"] == 7
    assert tm["slides_predicted"] == 3 and tm["predict_seconds_total"] > 0


def test_handle_request_serves_one_request(sessions):
    """`.handle_request()` answers one request in the calling thread."""
    _, ids, _, tsess = sessions
    server = make_server(tsess, port=0)
    host, port = server.server_address[:2]
    out = {}

    def client():
        conn = http.client.HTTPConnection(host, port, timeout=60)
        conn.request("POST", "/predict",
                     body=json.dumps({"slide_ids": ids[4:]}))
        r = conn.getresponse()
        out["status"], out["body"] = r.status, json.loads(r.read())
        conn.close()

    t = threading.Thread(target=client)
    t.start()
    server.handle_request()
    t.join(timeout=60)
    server.server_close()
    assert out["status"] == 200
    assert out["body"]["predictions"] == tsess.predict(ids[4:])


def test_concurrent_requests(sessions):
    """Four clients at once (a threaded server, one batch on the device at a
    time) each get their own slides' rows."""
    _, ids, _, tsess = sessions
    want = {sid: tsess.predict([sid])[0]["risk"] for sid in ids}
    run = _Running(make_server(tsess, port=0))
    results, errors = {}, []

    def worker(wid):
        try:
            req = [ids[(wid + k) % len(ids)] for k in range(3)]
            conn = http.client.HTTPConnection(*run.addr, timeout=60)
            conn.request("POST", "/predict", body=json.dumps({"slide_ids": req}))
            results[wid] = json.loads(conn.getresponse().read())["predictions"]
            conn.close()
        except Exception as e:        # noqa: BLE001
            errors.append((wid, e))

    try:
        threads = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        run.close()
    assert not errors, errors
    assert len(results) == 4
    for wid, rows in results.items():
        for k, row in enumerate(rows):
            sid = ids[(wid + k) % len(ids)]
            assert row["slide_id"] == sid
            np.testing.assert_allclose(row["risk"], want[sid], rtol=1e-6)


@pytest.mark.parametrize("flags,item", [
    (["--data-parallel", "2", "--artifact", "model.pt2z"],
     "live fused sessions"),
    (["--data-parallel", "2", "--batch-size", "3"],
     "multiple of the data axis")])
def test_unported_flags_raise(sessions, flags, item):
    """`--data-parallel` serves the live fused model only, at batch sizes
    the mesh divides (`tests/test_torch_parallel.py` serves with it)."""
    d = sessions[0]
    with pytest.raises(ValueError, match=item):
        main(["-m", d, "--device", "cpu"] + flags)
