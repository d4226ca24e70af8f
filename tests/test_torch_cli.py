"""``scripts/run_torch.py`` (the port's CLI) against ``scripts/run.py``: every
subcommand on the fake backends with ``--cpu``, over one persisted store a
package, gives the JAX CLI's output (times and the status's
package-specific parts aside); the CLI imports nothing of JAX; and
``scripts/eval_torch.py`` writes the WER record's keys and refuses to write
into ``docs/bench_runs/``."""

import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from audio_rag_tpu_torch.audio.io import write_wav
from torch_llm_common import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

CONFIG = """\
asr:
  backend: fake
diarization:
  backend: fake
embedding:
  backend: fake
retrieval:
  backend: tpu
  capacity_step: 128
  persist_dir: {persist}
reranking:
  backend: fake
generation:
  backend: fake
expansion:
  backend: none
chunking:
  min_chunk_tokens: 1
  overlap_tokens: 0
tts:
  backend: "null"
"""


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        name.replace(".py", ""), ROOT / "scripts" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def clis():
    return {"port": _script("run_torch.py"), "jax": _script("run.py")}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    wav = tmp / "lecture.wav"
    write_wav(wav, 0.1 * np.random.default_rng(3).standard_normal(
        16000 * 40).astype(np.float32))
    configs = {}
    for name in ("port", "jax"):
        cfg = tmp / f"{name}.yaml"
        cfg.write_text(CONFIG.format(persist=tmp / f"store_{name}"))
        configs[name] = cfg
    return wav, configs, tmp


def _run(clis, setup, name, args, capsys, monkeypatch):
    _, configs, tmp = setup
    monkeypatch.setattr(sys, "argv", [
        "run", "--cpu", "--config", str(configs[name]),
        "--configs-dir", str(tmp / "no-base"), *args])
    rc = clis[name].main()
    return rc, capsys.readouterr().out


def _both(clis, setup, args, capsys, monkeypatch):
    return [_run(clis, setup, name, args, capsys, monkeypatch)
            for name in ("port", "jax")]


def _no_times(text: str) -> str:
    """A CLI's text without its times: a query's milliseconds and the
    evaluation report's latency rows."""
    text = re.sub(r"\(\d+ ms,", "(_ ms,", text)
    return "\n".join(line for line in text.splitlines()
                     if "latency" not in line)


@pytest.mark.parametrize("seq", [
    [["ingest", "{wav}", "--metadata", '{"course": "cs229"}'],
     ["query", "word0 word1"],
     ["query", "word3", "--top-k", "2", "--search-type", "dense",
      "--no-rerank", "--answer"],
     ["query", "word2", "--json", "--answer"],
     ["status"],
     ["evaluate", "--answers", "--search-types", "hybrid"],
     ["evaluate", "--ragas", "--search-types", "dense"],
     ["clear"], ["clear"], ["query", "word0"]],
], ids=["every-subcommand"])
def test_cli_matches_run_py(clis, setup, seq, capsys, monkeypatch):
    wav = setup[0]
    for args in seq:
        args = [a.replace("{wav}", str(wav)) for a in args]
        (rc_t, out_t), (rc_j, out_j) = _both(clis, setup, args, capsys,
                                             monkeypatch)
        assert rc_t == rc_j, args
        if args[0] == "status":
            got, want = json.loads(out_t), json.loads(out_j)
            assert got["config"] == want["config"]
            assert got["collections"] == want["collections"] != {}
            assert set(got) == set(want)
            continue
        if args[0] == "ingest" or "--json" in args:
            got, want = json.loads(out_t), json.loads(out_j)
            for d in (got, want):
                d.pop("elapsed_s"), d.pop("stage_timings")
                for r in d.get("results", []):
                    r.pop("chunk_id")  # a random id a chunk
            assert got == want and (got.get("results")
                                    or got.get("num_chunks")), args
            continue
        assert _no_times(out_t) == _no_times(out_j), args
        assert out_t.strip(), args


def test_cli_imports_no_jax(setup):
    """The CLI in a process of its own: ``status`` answers and no module of
    JAX or of the JAX package was loaded."""
    _, configs, tmp = setup
    code = (
        "import atexit, runpy, sys\n"
        "atexit.register(lambda: print('BAD', sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'audio_rag_tpu'))))\n"
        f"sys.argv = ['run_torch.py', '--cpu', '--config', "
        f"{str(configs['port'])!r}, '--configs-dir', "
        f"{str(tmp / 'no-base')!r}, 'status']\n"
        "runpy.run_path('scripts/run_torch.py', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout and '"collections"' in out.stdout


def test_eval_torch_writes_the_record_keys(tmp_path, monkeypatch, capsys):
    """``eval_torch.py --cpu wer`` end to end on a cut set (one utterance,
    one multi-window file): the JSON of ``wer_tiny_synth.json``'s keys,
    printed and written to ``--out``; ``--out`` into docs/bench_runs/ is
    refused."""
    from audio_rag_tpu_torch.evaluation import wer_sets

    full = wer_sets.make_sets
    monkeypatch.setattr(wer_sets, "make_sets", lambda n: (lambda s: (
        wer_sets.SpeechSets(s.texts[:1], s.wavs[:1], s.stream_refs[:1],
                            s.stream_wavs[:1])))(full(n)))
    mod = _script("eval_torch.py")
    out = tmp_path / "wer.json"
    monkeypatch.setattr(sys, "argv", ["eval_torch.py", "--cpu", "--out",
                                      str(out), "wer", "--n", "2"])
    assert mod.main() == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    record = json.loads((ROOT / "docs" / "bench_runs"
                         / "wer_tiny_synth.json").read_text())
    assert json.loads(out.read_text()) == result
    assert set(result) == set(record)
    assert set(result["extra"]) == set(record["extra"])
    assert result["extra"]["tts_rendered"]["n_ref_words"] > 0
    assert result["extra"]["n_utterances"] == 1
    monkeypatch.setattr(sys, "argv", [
        "eval_torch.py", "--cpu", "--out",
        str(ROOT / "docs" / "bench_runs" / "x.json"), "quality"])
    with pytest.raises(SystemExit):
        mod.main()
    assert not (ROOT / "docs" / "bench_runs" / "x.json").exists()
