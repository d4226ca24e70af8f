"""The port's real-weight rehearsal (``scripts/load_real_torch.py``)
against the JAX package's (``scripts/load_real.py``) on the same tiny
HuggingFace-layout directories at ``tests/integration/test_load_real.py``'s
widths: classify → convert → preset detection → every engine loaded
through ``checkpoint_path`` → ingest → query (→ the evaluation sweep).

The directories are written from seeded trees by
``tests/torch_hf_layout.py`` (held against ``transformers``' own in
``test_torch_convert.py``). The JAX pipeline runs with
``mel_sharded=False``, as the port's parity tests run it (one device)."""

import contextlib
import io
import json
import sys
from pathlib import Path

import pytest
import torch

from audio_rag_tpu.asr.whisper_jax import WhisperJaxASR
from audio_rag_tpu_torch.asr.whisper import WhisperASR
from audio_rag_tpu_torch.core.exceptions import ConfigError
from audio_rag_tpu_torch.models.whisper import WHISPER_PRESETS, init_whisper
from torch_hf_common import ROOT
from torch_ledger_common import reset_ledgers
from torch_llm_common import one_torch_thread  # noqa: F401

sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT / "tests"))

import load_real as jax_load_real  # noqa: E402
import load_real_torch  # noqa: E402
import torch_hf_layout as layout  # noqa: E402

KINDS = {"bge-m3-test": "bgem3", "bge-reranker-test": "reranker",
         "llama-test": "llama", "not-a-model": None,
         "spkrec-ecapa-test": "speaker", "whisper-test": "whisper"}


@pytest.fixture(scope="module")
def models_dir(tmp_path_factory) -> Path:
    return layout.write_test_models(tmp_path_factory.mktemp("load_real"))


def _rehearse(module, models: Path, out: Path, *flags: str) -> dict:
    """Run ``module.main`` and keep its JSON lines, the preset names it
    detected and every transcript its ASR gave."""
    record: dict = {"transcripts": []}
    asr_cls = WhisperASR if module is load_real_torch else WhisperJaxASR
    build, words = module.build_config, asr_cls.transcribe_with_words

    def build_config(paths, *a):
        record["names"] = dict(paths["_names"])
        cfg = build(paths, *a)
        if module is jax_load_real:
            cfg.asr.mel_sharded = False
        return cfg

    def transcribe_with_words(self, *a, **kw):
        segs = words(self, *a, **kw)
        record["transcripts"] += [(s.text, round(s.start, 3),
                                   round(s.end, 3)) for s in segs]
        return segs

    buf = io.StringIO()
    reset_ledgers()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.setattr(module, "build_config", build_config)
        mp.setattr(asr_cls, "transcribe_with_words", transcribe_with_words)
        record["rc"] = module.main([str(models), "--out", str(out),
                                    "--collection", "rehearsal", *flags])
    reset_ledgers()
    record["lines"] = [json.loads(ln) for ln in buf.getvalue().splitlines()
                       if ln.startswith("{")]
    return record


@pytest.fixture(scope="module")
def rehearsals(models_dir, tmp_path_factory):
    out = tmp_path_factory.mktemp("out")
    return {"jax": _rehearse(jax_load_real, models_dir, out / "jax",
                             "--no-eval"),
            "port": _rehearse(load_real_torch, models_dir, out / "port",
                              "--no-eval", "--cpu")}


@pytest.mark.parametrize("name", sorted(KINDS))
def test_classify_matches_jax(models_dir, name):
    d = models_dir / name
    assert load_real_torch.classify(d) == jax_load_real.classify(d) \
        == KINDS[name]


def test_detect_model_names_matches_jax(models_dir):
    from audio_rag_tpu_torch.convert import CONVERTERS

    trees = {CONVERTERS[kind][1]: CONVERTERS[kind][0](models_dir / name)
             for name, kind in KINDS.items() if kind}
    got = load_real_torch.detect_model_names(trees)
    assert got == jax_load_real.detect_model_names(trees)
    assert got == {"whisper": "test", "llm": "test", "bgem3": "test",
                   "reranker": "test"}


def test_rehearsal_converts_the_same_set_and_presets(rehearsals):
    port, ref = rehearsals["port"], rehearsals["jax"]
    assert port["rc"] == ref["rc"] == 0
    kinds = [{e["kind"] for e in r["lines"] if "converted" in e}
             for r in (port, ref)]
    assert kinds[0] == kinds[1] == {"whisper", "llama", "bgem3", "reranker",
                                    "speaker"}
    params = [{e["kind"]: e["params"] for e in r["lines"] if "converted" in e}
              for r in (port, ref)]
    assert params[0] == params[1]
    assert port["names"] == ref["names"]


def test_rehearsal_ingests_the_same_chunks_and_transcripts(rehearsals):
    port, ref = rehearsals["port"], rehearsals["jax"]
    ingested = [[e for e in r["lines"] if "ingested" in e]
                for r in (port, ref)]
    assert [(e["chunks"], e["speakers"], e["duration_s"])
            for e in ingested[0]] == [(e["chunks"], e["speakers"],
                                       e["duration_s"]) for e in ingested[1]]
    assert ingested[0][0]["chunks"] > 0
    assert port["transcripts"] == ref["transcripts"]
    assert port["transcripts"]


def test_rehearsal_query_returns_results(rehearsals):
    for r in rehearsals.values():
        q = [e for e in r["lines"] if "query_results" in e]
        assert q and q[0]["query_results"] > 0


def test_port_rehearsal_runs_the_evaluation_sweep(models_dir, tmp_path):
    got = _rehearse(load_real_torch, models_dir, tmp_path / "conv", "--cpu")
    assert got["rc"] == 0
    ev = [e["evaluation"] for e in got["lines"] if "evaluation" in e]
    assert ev and set(ev[0]) == {"dense", "hybrid"}
    assert all(ev[0][t]["n"] > 0 for t in ev[0])


def test_preset_detection_rejects_unknown_dims(tmp_path):
    import dataclasses

    dims = dataclasses.replace(WHISPER_PRESETS["test"], n_vocab=333)
    d = tmp_path / "src" / "weird-whisper"
    layout.write_whisper(init_whisper(dims, seed=0), d, dims)
    with pytest.raises(SystemExit, match="match no preset"):
        load_real_torch.convert_all(d.parent, tmp_path / "out")


def test_rehearsal_runs_on_the_card_by_default(models_dir, tmp_path):
    """Without ``--cpu`` the pipeline is built for CUDA: without a card,
    the rehearsal raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(ConfigError, match="CUDA is not available"):
        load_real_torch.main([str(models_dir), "--out", str(tmp_path),
                              "--no-eval"])
