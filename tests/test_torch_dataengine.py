"""The port's data engine (``cambrian_tpu_torch/dataengine``) against the
JAX package's copy on the CPU: the offline stages give the same values and
files on the same inputs; the network stages, with ``requests`` replaced by
a stub that records every call and answers from canned replies, send the
same requests and write the same files. No network is used."""

import json
import os
import sys
import time
import types

import pytest

from cambrian_tpu import dataengine as jdataengine
from cambrian_tpu.dataengine import engine as jengine
from cambrian_tpu_torch import dataengine
from cambrian_tpu_torch.dataengine import engine


@pytest.fixture(params=["jax", "port"])
def eng(request):
    return {"jax": jengine, "port": engine}[request.param]


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _run_both(fn, tmp_path):
    """``fn(engine_module, workdir)`` for each package: (results, files)."""
    got = []
    for label, mod in (("jax", jengine), ("port", engine)):
        work = tmp_path / label
        work.mkdir()
        got.append((fn(mod, str(work)), _tree(work)))
    return got


def test_exports_match():
    names = [n for n in dir(jdataengine) if not n.startswith("_")]
    assert [n for n in dir(dataengine) if not n.startswith("_")] == names


@pytest.mark.parametrize("text", ['{"a": [1, 2]}', '```json\n{"a": 1}\n```',
                                  'Here you go:\n["x", "y"]', '```\n[{"q": "?"}]\n```'])
def test_extract_json_matches(text):
    assert engine._extract_json(text) == jengine._extract_json(text)


@pytest.mark.parametrize("name", ["A b/c?.json", "__x__y__", "Weird Name!.json", "ok.json"])
def test_slugify_matches(name):
    assert engine._slugify(name) == jengine._slugify(name)


def test_offline_stages_match(tmp_path):
    def run(mod, work):
        raw = os.path.join(work, "raw")
        os.makedirs(raw)
        replies = {"Physics.json": '```json\n{"Optics": ["lenses", "mirrors"], '
                                   '"Waves": {"Sound": ["pitch", 3]}}\n```',
                   "Bio logy.json": 'Sure:\n["cells", "genes"]',
                   "broken.json": "not json at all {{{", "notes.txt": "skipped"}
        for fname, text in replies.items():
            with open(os.path.join(raw, fname), "w") as f:
                f.write(text)
        norm = os.path.join(work, "norm")
        written = [os.path.relpath(p, work) for p in mod.process_json_files(raw, norm)]
        with open(os.path.join(norm, "Odd Name!.json"), "w") as f:
            f.write("{}")
        renamed = mod.clean_and_rename_files(norm)
        records = [{"topic": "optics", "images": ["lens.jpg", "mirror.jpg"],
                    "qa_pairs": [{"question": "What is shown?", "answer": "A lens."},
                                 {"question": "What reflects light?", "answer": "A mirror."},
                                 {"question": "Which one?", "answer": "The first."}]},
                   {"topic": "empty", "images": [], "qa_pairs": [{"question": "q",
                                                                  "answer": "a"}]}]
        vqa = mod.generate_vqa(records, os.path.join(work, "out", "vqa.json"), id_prefix="t")
        return written, renamed, vqa

    jax_side, port_side = _run_both(run, tmp_path)
    assert port_side == jax_side
    assert len(port_side[0][2]) == 3 and port_side[0][2][2]["image"] == "lens.jpg"


class _Response:
    def __init__(self, payload=None, content=b""):
        self._payload = payload
        self.content = content

    def raise_for_status(self):
        pass

    def json(self):
        return self._payload


class _Requests(types.ModuleType):
    """A stand-in for ``requests``: records (method, url, params, json,
    headers) of every call and answers from canned replies. The first chat
    call fails once, so that ``chat_completion``'s retry runs."""

    def __init__(self):
        super().__init__("requests")
        self.calls = []
        self.failed = False

    def post(self, url, headers=None, json=None, timeout=None):
        self.calls.append(("POST", url, None, json, headers))
        if not self.failed:
            self.failed = True
            raise ConnectionError("stub: first chat call fails")
        user = json["messages"][-1]["content"]
        if user.startswith("Generate"):
            reply = ('```json\n[{"question": "What bends light?", "answer": "A lens."}, '
                     '{"note": "no keys"}]\n```')
        else:
            field = user.split(": ", 1)[0]
            reply = f'{{"{field} basics": ["{field} lenses", "{field} mirrors"]}}'
        return _Response({"choices": [{"message": {"content": reply}}]})

    def get(self, url, params=None, timeout=None, headers=None):
        self.calls.append(("GET", url, params, None, headers))
        if url == jengine.CSE_URL:
            return _Response({"items": [{"title": "Lens", "link": "https://x/lens",
                                         "snippet": "optics"}, {"title": "Bare"}]})
        if url == jengine.WIKI_API_URL:
            if params.get("list") == "search":
                hit = [] if "mirrors" in params["srsearch"] else [
                    {"title": params["srsearch"].title()}]
                return _Response({"query": {"search": hit}})
            if params.get("prop") == "imageinfo":
                title = params["titles"]
                url = "" if "Missing" in title else f"https://upload/{title[5:]}"
                return _Response({"query": {"pages": {"1": {"imageinfo": [{"url": url}]}}}})
            return _Response({"query": {"pages": {"7": {
                "extract": f"All about {params['titles']}.",
                "images": [{"title": "File:Lens One.jpg"}, {"title": "File:Plot.svg"},
                           {"title": "File:Missing.png"}, {"title": "File:b.PNG"}]}}}})
        return _Response(content=b"image bytes of " + url.encode())

    def Session(self):
        return self


@pytest.fixture()
def stub(monkeypatch):
    monkeypatch.setenv("OPENAI_API_KEY", "sk-test")
    monkeypatch.setenv("GOOGLE_API_KEY", "g-test")
    monkeypatch.setenv("GOOGLE_SE_ID", "cse-test")
    monkeypatch.setattr(time, "sleep", lambda s: None)

    def install():
        fake = _Requests()
        monkeypatch.setitem(sys.modules, "requests", fake)
        return fake
    return install


def test_run_pipeline_sends_the_same_requests(stub, tmp_path):
    def run(mod, work):
        fake = stub()
        fields = os.path.join(work, "fields.txt")
        with open(fields, "w") as f:
            f.write("Physics: optics\nno separator here\nBio Logy: cells\n")
        out = mod.run_pipeline(fields, os.path.join(work, "w"), model="m", num_pairs=2)
        return out, json.dumps(fake.calls, sort_keys=True)

    jax_side, port_side = _run_both(run, tmp_path)
    assert port_side == jax_side
    (out, calls), files = port_side
    assert out and all(r["conversations"][0]["value"].startswith("<image>\n") for r in out)
    assert "w/pages/images/Lens_One.jpg" in files and "w/vqa.json" in files
    assert json.loads(calls)[0][0] == json.loads(calls)[1][0] == "POST"   # the retry


def test_google_search_and_chat_completion_match(stub, tmp_path):
    def run(mod, work):
        fake = stub()
        hits = mod.google_search("lens", num=3)
        reply = mod.chat_completion([{"role": "user", "content": "Optics: lenses"}],
                                    model="m", api_key="sk-given", max_retries=2)
        return hits, reply, json.dumps(fake.calls, sort_keys=True)

    jax_side, port_side = _run_both(run, tmp_path)
    assert port_side == jax_side
    hits = port_side[0][0]
    assert hits[1] == {"title": "Bare", "url": "", "description": ""}


def test_network_stages_need_keys(eng, monkeypatch):
    for key in ("OPENAI_API_KEY", "GOOGLE_API_KEY", "GOOGLE_SE_ID"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setitem(sys.modules, "requests", _Requests())
    with pytest.raises(EnvironmentError, match="OPENAI_API_KEY"):
        eng.chat_completion([{"role": "user", "content": "hi"}])
    with pytest.raises(EnvironmentError, match="GOOGLE_API_KEY"):
        eng.google_search("query")
