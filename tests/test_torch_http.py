"""PyTorch port, ``serve/http_server.py``: the HTTP front end over the port's
paged engine on the CPU. Completions must equal direct engine runs and the
reference's server over the reference's paged engine on the same weights;
streaming, validation, stats (a speculative engine's counters too) and
engine failures."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from ee274_convexcaldera_llm_quantization_tpu.serve import (
    http_server as JH, paged_engine as JPE)
from ee274_convexcaldera_llm_quantization_tpu_torch.serve import engine as TE
from ee274_convexcaldera_llm_quantization_tpu_torch.serve import (
    fast_engine as TFE, http_server as TH, paged_engine as TPE,
    spec_engine as TSE, speculative as TSP)

from test_torch_fused import (  # noqa: F401 (a fixture)
    _one_torch_thread, _params, _port_config)
from test_torch_model import _model

_KW = dict(max_slots=2, num_pages=16, page_size=8)


def _port_engine(**kw):
    config, _, tp = _model("tiny", "grouped")
    return TPE.PagedServingEngine(tp, _port_config(config), device="cpu",
                                  **dict(_KW, **kw))


def _prompt(n, seed=3):
    config = _model("tiny", "grouped")[0]
    return [int(t) for t in np.random.default_rng(seed).integers(
        1, config.vocab_size, n)]


@pytest.fixture(scope="module")
def server():
    srv = TH.ServingHTTPServer(_port_engine(), port=0).start()
    yield srv
    srv.stop()


def _url(srv, path):
    return f"http://{srv.host}:{srv.port}{path}"


def _post(srv, body, path="/v1/completions"):
    req = urllib.request.Request(
        _url(srv, path), data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(srv, path):
    with urllib.request.urlopen(_url(srv, path), timeout=60) as r:
        return json.loads(r.read())


def _direct(prompt, max_tokens):
    eng = _port_engine()
    eng.submit(TE.Request(uid=0, prompt=np.asarray(prompt, np.int32),
                          max_new_tokens=max_tokens))
    [comp] = eng.run()
    return comp.tokens


def _stream(srv, body):
    req = urllib.request.Request(
        _url(srv, "/v1/completions"),
        data=json.dumps(dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    chunks, fin = [], None
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            payload = line[len("data: "):]
            if payload == "[DONE]":
                break
            obj = json.loads(payload)
            if "tokens" in obj:
                chunks.append(obj["tokens"])
            if "finished_reason" in obj:
                fin = obj
    return chunks, fin


class TestHTTP:
    def test_health_and_stats(self, server):
        assert _get(server, "/health") == {"status": "ok"}
        before = _get(server, "/v1/stats")
        assert before["max_slots"] == 2 and before["active_slots"] == 0
        _post(server, {"prompt": _prompt(4, seed=9), "max_tokens": 3})
        after = _get(server, "/v1/stats")
        assert after["tokens_generated"] == before["tokens_generated"] + 3
        assert after["steps"] > before["steps"]
        assert after["queue_depth"] == 0

    def test_completion_matches_direct_engine(self, server):
        prompt = _prompt(5)
        out = _post(server, {"prompt": prompt, "max_tokens": 8})
        assert out["finished_reason"] == "length"
        assert out["prompt_len"] == 5
        assert out["tokens"] == _direct(prompt, 8)

    def test_concurrent_clients(self, server):
        prompts = [_prompt(4 + i, seed=50 + i) for i in range(4)]
        results = {}

        def worker(i):
            results[i] = _post(server, {"prompt": prompts[i],
                                        "max_tokens": 6})

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
        assert sorted(results) == [0, 1, 2, 3]
        for i in range(4):
            assert results[i]["tokens"] == _direct(prompts[i], 6)

    def test_streaming(self, server):
        prompt = _prompt(5, seed=4)
        chunks, fin = _stream(server, {"prompt": prompt, "max_tokens": 8})
        assert fin["finished_reason"] == "length"
        assert [t for c in chunks for t in c] == _direct(prompt, 8)

    def test_validation_errors(self, server):
        for body in ({}, {"prompt": []}, {"prompt": "text"},
                     {"prompt": [1.5, 2]},
                     {"prompt": _prompt(5), "max_tokens": 200}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(server, body)
            assert e.value.code == 400
        for path in ("/v1/other", "/nowhere"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(server, {"prompt": [1]}, path=path)
            assert e.value.code == 404

    def test_matches_reference_server(self):
        # the reference's server over the reference's paged engine on the
        # same weights answers the same greedy tokens
        config, jp, _ = _model("tiny", "grouped")
        ref = JH.ServingHTTPServer(JPE.PagedServingEngine(
            jp, config, use_pallas=False, **_KW), port=0).start()
        port = TH.ServingHTTPServer(_port_engine(), port=0).start()
        try:
            for seed in (11, 12):
                body = {"prompt": _prompt(6, seed=seed), "max_tokens": 5}
                a, b = _post(ref, body), _post(port, body)
                assert a["tokens"] == b["tokens"]
                assert a["finished_reason"] == b["finished_reason"]
        finally:
            ref.stop()
            port.stop()

    def test_slotted_engine_and_tokenizer(self):
        config, _, tp = _model("tiny", "grouped")
        eng = TE.ServingEngine(tp, _port_config(config), max_slots=1,
                               max_seq_len=64, device="cpu")
        srv = TH.ServingHTTPServer(
            eng, port=0,
            tokenizer=lambda s: [ord(c) % config.vocab_size for c in s]
        ).start()
        try:
            out = _post(srv, {"prompt": "hello", "max_tokens": 4})
            assert len(out["tokens"]) == 4 and out["prompt_len"] == 5
            assert _get(srv, "/v1/stats")["max_slots"] == 1
        finally:
            srv.stop()

    def test_speculative_engine_and_its_counters(self):
        # the speculative engine behind the server answers the fast
        # engine's greedy tokens, and the stats report its rounds and
        # accepted tokens (as the reference's server does)
        config, _, tp = _params("tiny")
        cfg = _port_config(config)
        draft, dcfg = TSP.truncate_draft(tp, cfg, 1)
        kw = dict(max_slots=2, max_seq_len=64, device="cpu")
        srv = TH.ServingHTTPServer(TSE.SpeculativeServingEngine(
            tp, draft, cfg, dcfg, gamma=3, **kw), port=0).start()
        try:
            before = _get(srv, "/v1/stats")
            assert before["spec_rounds"] == before["accepted_tokens"] == 0
            prompt = _prompt(6, seed=21)
            out = _post(srv, {"prompt": prompt, "max_tokens": 8})
            eng = TFE.FastServingEngine(tp, cfg, **kw)
            eng.submit(TE.Request(uid=0, prompt=np.asarray(prompt, np.int32),
                                  max_new_tokens=8))
            assert out["tokens"] == eng.run()[0].tokens
            stats = _get(srv, "/v1/stats")
            assert stats["spec_rounds"] > 0
            assert 0 <= stats["accepted_tokens"] <= 3 * stats["spec_rounds"]
            assert stats["tokens_generated"] == 8
        finally:
            srv.stop()
        # engines without speculation report no such counters
        assert "spec_rounds" not in TH.AsyncEngineRunner(
            _port_engine()).stats()

    @pytest.mark.filterwarnings(
        "ignore::pytest.PytestUnhandledThreadExceptionWarning")
    def test_engine_failure_is_reported(self):
        # an engine step that raises answers the waiting request with 500
        # instead of leaving it to time out
        class Broken(TPE.PagedServingEngine):
            def step(self):
                raise RuntimeError("device step failed")

        config, _, tp = _model("tiny", "grouped")
        srv = TH.ServingHTTPServer(
            Broken(tp, _port_config(config), device="cpu", **_KW),
            port=0).start()
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(srv, {"prompt": [1, 2, 3], "max_tokens": 2})
            assert e.value.code == 500
            assert "device step failed" in json.loads(e.value.read())["error"]
            assert isinstance(srv.runner.error, RuntimeError)
        finally:
            srv.stop()

    def test_completion_json(self):
        comp = TE.Completion(uid=3, tokens=[np.int64(4), 5], prompt_len=2,
                             finished_reason="eos", latency_s=0.123456)
        assert TH._completion_json(comp) == {
            "uid": 3, "tokens": [4, 5], "prompt_len": 2,
            "finished_reason": "eos", "latency_s": 0.1235}
