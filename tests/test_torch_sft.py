"""The SFT data pipeline in the port against the JAX package: ``prepare_sample``
on a tokenizer the test writes, ``get_batch`` and ``length_grouped_indices``
bit for bit for the same seeds, and ``.pt`` / ``.npz`` sample files written
by either package and read by the other."""

import numpy as np
import pytest

from lit_llama_tpu.data import sft as jsft
from lit_llama_tpu.data.tokenizer import Tokenizer as JaxTokenizer
from lit_llama_tpu_torch.data import sft as tsft
from lit_llama_tpu_torch.data import sp_model
from lit_llama_tpu_torch.data.tokenizer import Tokenizer

LETTERS = "abcdefghijklmnopqrstuvwxyz"


def write_tokenizer(path, n_pieces=128):
    """A BPE tokenizer of ``n_pieces`` pieces (letters, a few marks, word
    starts and vowel pairs), written by the port's ``serialize_model``."""
    pieces = [sp_model.Piece("<unk>", 0.0, sp_model.UNKNOWN), sp_model.Piece("<s>", 0.0, sp_model.CONTROL),
              sp_model.Piece("</s>", 0.0, sp_model.CONTROL), sp_model.Piece(sp_model.WS, -1.0)]
    pieces += [sp_model.Piece(c, -2.0 - i) for i, c in enumerate(LETTERS + "?.,'")]
    merges = [sp_model.WS + c for c in LETTERS] + [a + b for a in "aeiou" for b in LETTERS]
    pieces += [sp_model.Piece(m, -100.0 - i) for i, m in enumerate(merges[: n_pieces - len(pieces)])]
    path.write_bytes(sp_model.serialize_model(sp_model.SPModel(pieces=pieces, model_type=2)))
    return path


def random_examples(n, seed, max_words=40):
    rng = np.random.default_rng(seed)

    def words(k):
        return " ".join("".join(rng.choice(list(LETTERS), size=int(rng.integers(1, 9)))) for _ in range(k))

    return [{"instruction": words(int(rng.integers(1, max_words))),
             "input": words(int(rng.integers(1, 10))) if rng.random() < 0.5 else "",
             "output": " " + words(int(rng.integers(1, max_words)))} for _ in range(n)]


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    path = write_tokenizer(tmp_path_factory.mktemp("tok") / "tokenizer.model")
    return JaxTokenizer(path), Tokenizer(path)


@pytest.fixture(scope="module")
def samples(tokenizers):
    return [jsft.prepare_sample(ex, tokenizers[0], 200) for ex in random_examples(40, 0)]


@pytest.mark.parametrize("max_length,mask_inputs", [(512, True), (512, False), (60, True)])
def test_prepare_sample_matches_jax(tokenizers, max_length, mask_inputs):
    jt, tt = tokenizers
    for ex in random_examples(12, 1):
        want = jsft.prepare_sample(ex, jt, max_length, mask_inputs)
        got = tsft.prepare_sample(ex, tt, max_length, mask_inputs)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == np.int32 and want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert (got["labels"] == tsft.IGNORE_INDEX).any() == mask_inputs
    assert tsft.generate_prompt(ex) == jsft.generate_prompt(ex)


@pytest.mark.parametrize("accum,max_seq_length,sequential", [(1, None, False), (3, None, False), (2, 64, False),
                                                             (2, None, True), (3, 64, True)])
def test_get_batch_matches_jax(samples, accum, max_seq_length, sequential):
    """Five batches in a row from one generator each (the draws chain)."""
    jrng, trng = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(5):
        want = jsft.get_batch(samples, 4, jrng, accum, max_seq_length=max_seq_length, sequential=sequential)
        got = tsft.get_batch(samples, 4, trng, accum, max_seq_length=max_seq_length, sequential=sequential)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32 and g.shape == w.shape and g.shape[:2] == (accum, 4)
            np.testing.assert_array_equal(g, w)
        assert got[0].shape[-1] % 64 == 0 or got[0].shape[-1] == max_seq_length
    assert jrng.integers(1 << 30) == trng.integers(1 << 30)  # both generators advanced alike


@pytest.mark.parametrize("n,batch,mega", [(40, 4, 50), (37, 2, 3), (5, 4, 1), (0, 4, 2)])
def test_length_grouped_indices_matches_jax(n, batch, mega):
    """One megabatch, several (the longest of all in a later one: swapped to
    the front), a partial last one, and no samples."""
    lengths = list(np.random.default_rng(n).integers(1, 300, size=n))
    jrng, trng = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(3):
        want = jsft.length_grouped_indices(lengths, batch, jrng, mega)
        got = tsft.length_grouped_indices(lengths, batch, trng, mega)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        if n:
            assert lengths[int(got[0])] == max(lengths) and sorted(got.tolist()) == list(range(n))


@pytest.mark.parametrize("suffix", [".pt", ".npz"])
def test_sample_files_cross_both_ways(tmp_path, samples, suffix):
    jsft.save_samples(samples, tmp_path / f"jax{suffix}")
    tsft.save_samples(samples, tmp_path / f"port{suffix}")
    for got in (tsft.load_samples(tmp_path / f"jax{suffix}"), jsft.load_samples(tmp_path / f"port{suffix}")):
        assert len(got) == len(samples)
        for g, w in zip(got, samples):
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].dtype == np.int32
                np.testing.assert_array_equal(g[k], w[k])
    if suffix == ".npz":  # the bytes of the arrays are the JAX writer's
        a, b = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
