"""The data preparation entry points on the CPU against the JAX scripts:
``prepare_alpaca``, ``prepare_dolly``, ``prepare_any_text`` and
``prepare_redpajama`` (sample and full mode) write files byte-equal to the JAX
package's on local inputs that the test writes; every ``--help`` prints, and
every new module imports with the JAX package and jax blocked."""

import importlib.util
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from lit_llama_tpu_torch.data import sft as tsft
from lit_llama_tpu_torch.data.tokenizer import Tokenizer
from lit_llama_tpu_torch.scripts import prepare_alpaca, prepare_any_text, prepare_dolly, prepare_redpajama

ROOT = Path(__file__).resolve().parent.parent
WORDS = ("the quick brown fox jumps over a lazy dog while five wizards box and "
         "pack my jugs with liquor instruction input response below task").split()
NEW_MODULES = ("scripts.convert_checkpoint", "scripts.convert_hf_checkpoint", "scripts.convert_lora_weights",
               "serve.http", "scripts.prepare_shakespeare", "pretrain.shakespeare", "scripts.prepare_alpaca",
               "scripts.prepare_dolly", "scripts.prepare_any_text", "scripts.prepare_redpajama",
               "scripts.make_tiny_checkpoint", "scripts.prepare_code_corpus", "scripts.download",
               "tools.gptq_65b_dryrun")


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _text(rng, lo=3, hi=30):
    return " ".join(rng.choice(WORDS, size=int(rng.integers(lo, hi))))


@pytest.fixture(scope="module")
def tokenizer_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("tok")
    rng = np.random.default_rng(0)
    corpus = "\n".join(_text(rng) for _ in range(200)) + "\n" + tsft.generate_prompt(
        {"instruction": "x", "input": "y"}) + " :#.,'-?"
    (d / "corpus.txt").write_text(corpus)
    Tokenizer.train(str(d / "corpus.txt"), str(d), 200)
    return d / "tokenizer.model"


def _same_files(a: Path, b: Path):
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    return names


@pytest.mark.parametrize("mask_inputs", [False, True])
def test_prepare_alpaca_matches_jax(tmp_path, tokenizer_path, monkeypatch, mask_inputs):
    monkeypatch.setenv("LIT_LLAMA_TPU_PLATFORM", "cpu")
    rng = np.random.default_rng(1)
    data = [{"instruction": _text(rng), "input": _text(rng, 0, 10) if i % 2 else "", "output": _text(rng)}
            for i in range(30)]
    src = tmp_path / "alpaca.json"
    src.write_text(json.dumps(data))
    kw = dict(tokenizer_path=tokenizer_path, test_split_size=7, max_seq_length=128, mask_inputs=mask_inputs,
              data_file=src)
    prepare_alpaca.prepare(destination_path=tmp_path / "port", **kw)
    _jax_script("prepare_alpaca").prepare(destination_path=tmp_path / "jax", **kw)
    assert _same_files(tmp_path / "port", tmp_path / "jax") == ["test.pt", "train.pt"]
    samples = tsft.load_samples(tmp_path / "port" / "test.pt")
    assert len(samples) == 7 and all(len(s["input_ids"]) <= 128 for s in samples)
    assert (min(int(s["labels"][0]) for s in samples) == -1) == mask_inputs
    with pytest.raises(FileNotFoundError):  # no local file: nothing is downloaded
        prepare_alpaca.prepare(destination_path=tmp_path / "none", tokenizer_path=tokenizer_path)


def test_prepare_dolly_matches_jax(tmp_path, tokenizer_path, monkeypatch):
    monkeypatch.setenv("LIT_LLAMA_TPU_PLATFORM", "cpu")
    rng = np.random.default_rng(2)
    src = tmp_path / "dolly.jsonl"
    src.write_text("\n".join(json.dumps({"instruction": _text(rng), "context": _text(rng, 0, 8),
                                         "response": _text(rng), "category": "qa"}) for _ in range(25)) + "\n\n")
    kw = dict(tokenizer_path=tokenizer_path, test_split_size=5, max_seq_length=96, data_file=src)
    prepare_dolly.prepare(destination_path=tmp_path / "port", **kw)
    _jax_script("prepare_dolly").prepare(destination_path=tmp_path / "jax", **kw)
    _same_files(tmp_path / "port", tmp_path / "jax")
    assert len(tsft.load_samples(tmp_path / "port" / "train.pt")) == 20


def test_prepare_any_text_matches_jax(tmp_path, tokenizer_path, monkeypatch):
    monkeypatch.setenv("LIT_LLAMA_TPU_PLATFORM", "cpu")
    rng = np.random.default_rng(3)
    src = tmp_path / "lines.txt"
    src.write_text("\n".join(_text(rng, 1, 60) if i % 5 else "  " for i in range(40)))
    kw = dict(train_data_path=src, tokenizer_path=tokenizer_path, test_split_ratio=0.75, max_seq_length=32)
    prepare_any_text.prepare(destination_path=tmp_path / "port", **kw)
    _jax_script("prepare_any_text").prepare(destination_path=tmp_path / "jax", **kw)
    _same_files(tmp_path / "port", tmp_path / "jax")
    s = tsft.load_samples(tmp_path / "port" / "train.pt")[0]
    assert np.array_equal(s["input_ids"], s["labels"]) and len(s["input_ids"]) <= 32


def _jsonl(path: Path, rng, n: int):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(json.dumps({"text": _text(rng, 1, 80), "meta": {}}) + "\n" for _ in range(n)))


@pytest.mark.parametrize("sample", [True, False])
def test_prepare_redpajama_matches_jax(tmp_path, tokenizer_path, monkeypatch, sample):
    """Sample mode over the eleven sample files; full mode over every source,
    common_crawl zstd-compressed."""
    monkeypatch.setenv("LIT_LLAMA_TPU_PLATFORM", "cpu")
    rng = np.random.default_rng(4)
    src = tmp_path / "src"
    if sample:
        for name in prepare_redpajama.filenames_sample:
            _jsonl(src / name, rng, 6)
    else:
        zstd = pytest.importorskip("zstandard")
        for set_name, pattern in prepare_redpajama.filename_sets.items():
            path = src / pattern.replace("*", "_part0.jsonl")
            _jsonl(path, rng, 6)
            if set_name == "common_crawl":
                path.with_suffix(".jsonl.zst").write_bytes(zstd.ZstdCompressor().compress(path.read_bytes()))
                path.unlink()
    kw = dict(source_path=src, tokenizer_path=tokenizer_path, chunk_size=97, sample=sample)
    prepare_redpajama.prepare(destination_path=tmp_path / "port", **kw)
    _jax_script("prepare_redpajama").prepare(destination_path=tmp_path / "jax", **kw)
    names = _same_files(tmp_path / "port", tmp_path / "jax")
    prefixes = {n.rsplit("_", 1)[0] for n in names}
    assert len(prefixes) == (11 if sample else 7) and len(names) > len(prefixes)


def test_new_entry_points_print_help_and_import_without_jax():
    """Each new module imports with ``jax`` and ``lit_llama_tpu`` blocked in
    ``sys.modules``, and each ``--help`` prints (one process for all)."""
    code = textwrap.dedent(f"""
        import contextlib, importlib, io, sys
        sys.modules["jax"] = None
        sys.modules["lit_llama_tpu"] = None
        sys.path.insert(0, {str(ROOT)!r})
        from lit_llama_tpu_torch.utils.cli import cli
        for name in {NEW_MODULES!r}:
            mod = importlib.import_module("lit_llama_tpu_torch." + name)
            fn = next(getattr(mod, f) for f in ("main", "prepare", "convert_checkpoint", "convert_hf_checkpoint",
                                                "download_from_hub") if hasattr(mod, f))
            out = io.StringIO()
            with contextlib.redirect_stdout(out), contextlib.suppress(SystemExit):
                cli(fn, ["--help"])
            assert "usage:" in out.getvalue() and ("--device" in out.getvalue()) != getattr(fn, "host_only", False), name
        import lit_llama_tpu_torch.native.tokenizer, lit_llama_tpu_torch.native.build
        assert not any(m == "jax" or m.startswith(("jax.", "lit_llama_tpu.")) for m in sys.modules if sys.modules[m])
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-3000:]


def test_cli_requires_the_host_only_marker():
    from lit_llama_tpu_torch.utils.cli import cli, host_only

    def no_device(x: int = 1):
        """Args:
            x: a number."""
        return x

    with pytest.raises(TypeError, match="host_only"):
        cli(no_device, ["--x", "2"])
    assert cli(host_only(no_device), ["--x", "2"]) == 2

    @host_only
    def with_device(device: str = None):
        return device

    with pytest.raises(TypeError, match="host_only"):
        cli(with_device, [])
