"""``finetune.adapter --model_parallel 2`` under ``torchrun`` on the CPU
(two gloo ranks, each rank's prefix attention on its head) against the same
entry point run in one process; the Adapter v1 step under TP itself is held
to JAX's (1, 2) GSPMD step in ``tests/test_torch_dist_finetune.py``.

Tolerances, f32: the logged losses to their 4 decimals, the prompt and the
gates to rtol 1e-6, atol 1e-2 lr, as ``finetune.lora --data_parallel 2`` is
held there."""

from pathlib import Path

import numpy as np
import torch

from lit_llama_tpu_torch.utils.checkpoint import load_checkpoint, tree_leaves
from tests import torch_parallel_ranks as ranks
from tests.test_torch_finetune import HYPER, work  # noqa: F401 (a module fixture: the tiny .pth, tokenizer and data)

ROOT = Path(__file__).resolve().parent.parent


def test_finetune_adapter_model_parallel_under_torchrun(work, tmp_path, capsys):  # noqa: F811
    """``finetune.adapter --model_parallel 2`` under torchrun (each rank's
    prefix attention on its head, f32 on the CPU): its losses and
    validation loss are the one-process run's, rank 0 writes the prompt and
    the gates gathered whole (the single-process checkpoint's leaves), and
    ``generate.adapter`` loads it as it is, with the one-process run's
    greedy tokens."""
    from lit_llama_tpu_torch.finetune import adapter as adapter_entry
    from lit_llama_tpu_torch.generate import adapter as gen_adapter
    from lit_llama_tpu_torch.training import finetune as tft

    flags = dict(data_dir=work / "data", checkpoint_path=work / "lit-llama.pth", tokenizer_path=work / "tokenizer.model",
                 learning_rate=9e-3, **HYPER)
    args = [a for k, v in flags.items() for a in (f"--{k}", v)]
    wait = ranks.torchrun("lit_llama_tpu_torch.finetune.adapter",
                          args + ["--out_dir", tmp_path / "two", "--model_parallel", 2], tmp_path / "two.log", ROOT)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # as each rank runs (OMP_NUM_THREADS=2), beside the other test workers
    try:
        adapter_entry.main(out_dir=tmp_path / "one", device="cpu", **flags)  # while the ranks run
    finally:
        torch.set_num_threads(threads)
    text = wait()
    assert "backend gloo" in text
    one, two = ranks.metrics(tmp_path / "one"), ranks.metrics(tmp_path / "two")
    assert [r["iter"] for r in one] == [r["iter"] for r in two]
    for a, b in zip(one, two):
        for k in ("loss", "val_loss"):
            if k in a:
                np.testing.assert_allclose(b[k], a[k], rtol=1e-4, atol=1e-4)  # the logs round to 4 places
    name = tft.CHECKPOINT_NAMES["adapter"]
    got = tree_leaves(load_checkpoint(tmp_path / "two" / name)["params"])
    want = tree_leaves(load_checkpoint(tmp_path / "one" / name)["params"])
    assert sorted(got) == sorted(want) == ["h/adapter_wte", "h/gating"]
    for n in want:
        assert got[n].shape == want[n].shape, n
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), rtol=1e-6, atol=1e-2 * 9e-3, err_msg=n)
    assert float(want["h/gating"].abs().max()) > 0  # the gates moved from zero
    capsys.readouterr()
    tokens = []
    for run in ("one", "two"):
        gen_adapter.main(adapter_path=tmp_path / run / name, checkpoint_path=work / "lit-llama.pth",
                         tokenizer_path=work / "tokenizer.model", max_new_tokens=8, temperature=0.0, device="cpu")
        tokens.append([line for line in capsys.readouterr().err.splitlines() if line.startswith("Token ids:")])
    assert len(tokens[0]) == 1 and tokens[0] == tokens[1]
