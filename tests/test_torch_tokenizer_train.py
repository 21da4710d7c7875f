"""Tokenizer training and the native encoder on the CPU against the JAX
package: ``train_bpe``'s serialized models byte for byte (ties included),
``prepare_shakespeare``'s three files byte for byte, the C++ encoder's ids
against the Python encoder's and JAX's ``NativeEncoder``'s, and two processes
that build the encoder at once."""

import importlib.util
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from lit_llama_tpu.data import sp_model as jsp
from lit_llama_tpu.data.tokenizer import train_bpe as jtrain_bpe
from lit_llama_tpu.native import tokenizer as jnative
from lit_llama_tpu_torch.data import sp_model as tsp
from lit_llama_tpu_torch.data.tokenizer import Tokenizer, train_bpe
from lit_llama_tpu_torch.native import tokenizer as tnative
from lit_llama_tpu_torch.scripts import prepare_shakespeare as tprep

ROOT = Path(__file__).resolve().parent.parent
ALPHABET = list("abcdefghij") + ["é", "ß", "—"]


def _corpus(seed: int, n_words: int = 600) -> str:
    """Lines of seeded words over a small alphabet (with non-ASCII letters)."""
    rng = np.random.default_rng(seed)
    words = ["".join(rng.choice(ALPHABET, size=rng.integers(1, 7))) for _ in range(60)]
    picks = rng.choice(words, size=n_words, p=np.arange(60, 0, -1) / np.arange(60, 0, -1).sum())
    return "\n".join(" ".join(picks[i : i + 12]) for i in range(0, n_words, 12))


# a corpus whose pair counts tie everywhere: (count, pair) order decides every merge
TIES = "ab ba cd dc ab ba cd dc\nxy yx xy yx ab cd\n" * 3


@pytest.mark.parametrize("corpus,vocab_size", [(0, 40), (1, 120), (2, 400), ("ties", 30), ("ties", 1000)])
def test_train_bpe_bytes_match_jax(corpus, vocab_size):
    text = TIES if corpus == "ties" else _corpus(corpus)
    got = tsp.serialize_model(train_bpe(text, vocab_size))
    want = jsp.serialize_model(jtrain_bpe(text, vocab_size))
    assert got == want
    assert tsp.parse_model(got).vocab_size() <= vocab_size


def test_train_bpe_refuses_a_vocab_below_the_characters():
    text = _corpus(3)
    n_base = 3 + len({c for w in text.split() for c in "▁" + w})
    with pytest.raises(ValueError, match="vocab_size"):
        train_bpe(text, n_base - 1)
    with pytest.raises(ValueError):
        jtrain_bpe(text, n_base - 1)
    assert train_bpe(text, n_base).vocab_size() == n_base


def test_prepare_shakespeare_files_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("LIT_LLAMA_TPU_PLATFORM", "cpu")
    src = tmp_path / "corpus.txt"
    src.write_text(_corpus(4, 3000) + "\nFirst Citizen:\nBefore we proceed any further, hear me speak.\n")
    tprep.prepare(destination_path=tmp_path / "port", vocab_size=100, input_file=src)
    spec = importlib.util.spec_from_file_location("jax_prepare_shakespeare", ROOT / "scripts" / "prepare_shakespeare.py")
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    jmod.prepare(destination_path=tmp_path / "jax", vocab_size=100, input_file=src)
    for name in ("input.txt", "tokenizer.model", "train.bin", "val.bin"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    assert not (tmp_path / "port" / "_train_corpus.txt").exists()
    ids = np.fromfile(tmp_path / "port" / "train.bin", np.uint16)
    assert len(ids) > 0 and ids.max() < 100
    # without --input_file the corpus must already be in the destination; nothing is downloaded
    tprep.prepare(destination_path=tmp_path / "port", vocab_size=100)
    with pytest.raises(FileNotFoundError):
        tprep.prepare(destination_path=tmp_path / "empty", vocab_size=100)


TEXTS = [
    "the quick brown fox",
    "hello unseen WORDS here",
    "  extra   spaces\tand\nnewlines  ",
    "",
    " ",
    "unicode: déjà vu — ça va? ✓",
    "a",
    "the " * 200,
    "line one\nline two\n\nline four",
    "nbsp here and  doubled",
    " \n leading mix \n ",
]


def _byte_fallback_pieces(sp):
    pieces = [sp.Piece("<unk>", 0.0, sp.UNKNOWN), sp.Piece("<s>", 0.0, sp.CONTROL), sp.Piece("</s>", 0.0, sp.CONTROL)]
    pieces += [sp.Piece(f"<0x{b:02X}>", 0.0, sp.BYTE) for b in range(256)]
    pieces += [sp.Piece("hi", -1.0), sp.Piece("▁hi", -2.0), sp.Piece("▁", -3.0), sp.Piece("▁the", -1.5)]
    return pieces


def _unigram_pieces(sp):
    pieces = [sp.Piece("<unk>", 0.0, sp.UNKNOWN), sp.Piece("<s>", 0.0, sp.CONTROL), sp.Piece("</s>", 0.0, sp.CONTROL)]
    pieces += [sp.Piece(p, s) for p, s in (("▁", -2.0), ("a", -3.0), ("b", -3.5), ("ab", -4.0), ("▁ab", -3.2),
                                           ("ba", -3.1), ("▁the", -2.5), ("t", -4.0), ("h", -4.0), ("e", -4.0))]
    return pieces


def _models(kind):
    if kind == "bpe":
        text = _corpus(5)
        return train_bpe(text, 150), jtrain_bpe(text, 150), TEXTS + [text]
    if kind == "byte_fallback":
        return (tsp.SPModel(pieces=_byte_fallback_pieces(tsp), model_type=2, byte_fallback=True),
                jsp.SPModel(pieces=_byte_fallback_pieces(jsp), model_type=2, byte_fallback=True), TEXTS)
    return (tsp.SPModel(pieces=_unigram_pieces(tsp), model_type=1), jsp.SPModel(pieces=_unigram_pieces(jsp), model_type=1),
            TEXTS + ["ab", "abba", "the ab", "abab ba", "xyz ab"])


@pytest.mark.parametrize("kind", ["bpe", "byte_fallback", "unigram"])
def test_native_encoder_matches_python_and_jax(kind):
    if not tnative.available() or not jnative.available():
        pytest.skip("no C++ toolchain")
    port_model, jax_model, texts = _models(kind)
    enc, jenc = tnative.NativeEncoder(port_model), jnative.NativeEncoder(jax_model)
    for t in texts:
        want = port_model.encode_py(t)
        assert enc.encode(t) == want == jenc.encode(t) == jax_model.encode_py(t), repr(t)
        assert port_model.encode(t) == want  # encode takes the native path
    assert port_model._native() is not None


def test_tokenizer_falls_back_to_python_without_the_native_encoder(tmp_path, monkeypatch):
    (tmp_path / "c.txt").write_text(_corpus(6))
    Tokenizer.train(str(tmp_path / "c.txt"), str(tmp_path), 80)
    monkeypatch.setenv("LIT_LLAMA_TPU_NO_NATIVE", "1")
    tok = Tokenizer(tmp_path / "tokenizer.model")
    assert tok.processor._native() is None
    ids = tok.encode(_corpus(7, 100), bos=True, eos=True)
    monkeypatch.delenv("LIT_LLAMA_TPU_NO_NATIVE")
    assert ids.tolist() == Tokenizer(tmp_path / "tokenizer.model").encode(_corpus(7, 100), bos=True, eos=True).tolist()


def test_two_processes_build_the_encoder_at_once(tmp_path):
    """Each build compiles to a file of its own and moves it into place, so
    two processes that start together both load a whole library."""
    if not tnative.available():
        pytest.skip("no C++ toolchain")
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(ROOT)!r})
        from pathlib import Path
        from lit_llama_tpu_torch.native import build, tokenizer
        build.BUILD_DIR = Path({str(tmp_path / "native")!r})
        from lit_llama_tpu_torch.data.tokenizer import train_bpe
        model = train_bpe("ab ba abc cab", 20)
        assert tokenizer.available()
        assert tokenizer.NativeEncoder(model).encode("abc ab") == model.encode_py("abc ab")
        print("ok")
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
    assert all(o[0].strip() == "ok" for o in outs)
    built = list((tmp_path / "native").iterdir())
    assert len(built) == 1 and built[0].suffix == ".so"  # one library, no temporary left behind
