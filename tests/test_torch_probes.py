"""P1-P5, the probes of K1's building blocks (tools/probe_kernels.py): each
case's plain version against the same construct in jax.numpy on the CPU (the
constructs of scripts/probe_mosaic.py), the tool's command line on the CPU, and
each CUDA probe against its plain version on the card (skipped without
one)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lit_llama_tpu.ops.linear import dequantize_int4 as j_dequantize_int4
from lit_llama_tpu_torch.tools import probe_kernels as pk

H, ROWS, HS = pk.H, pk.ROWS, pk.HS


def _jnp(t):
    return jnp.asarray(t.float().numpy())


def _jax_case(name, args):
    """The case's construct written in jax.numpy, as scripts/probe_mosaic.py
    writes it inside its kernels."""
    if name == "dot_nt":
        a, b = map(_jnp, args)
        return jnp.einsum("md,nd->mn", a, b)
    if name == "iota_mask_dots":
        q, k = map(_jnp, args)
        s_all = q @ k.T
        r = jnp.arange(H)[:, None]
        c = jnp.arange(H * ROWS)[None, :]
        mask = (c // ROWS == r).astype(jnp.float32)
        sel = (jnp.arange(H * ROWS)[:, None] % ROWS == jnp.arange(ROWS)[None, :]).astype(jnp.float32)
        return (s_all * mask) @ sel
    if name == "reshape3":
        q, k = map(_jnp, args)
        return q @ k.reshape(H * ROWS, HS).T
    if name == "mv_small_n":
        x, w = args
        wj = {k: jnp.asarray(v.numpy()) for k, v in w.items() if k in ("qw", "qscale", "qzero")}
        return _jnp(x) @ j_dequantize_int4(wj, jnp.float32)
    if name == "concat":
        (x,) = map(_jnp, args)
        return jnp.concatenate([x[:, i * 128 : (i + 1) * 128] * (i + 1.0) for i in range(4)], axis=1)
    raise KeyError(name)


@pytest.mark.parametrize("name", sorted(pk.CASES))
def test_probe_plain_matches_jax(name):
    """f32 cases to 1e-5 (the same products summed in another order); P4's
    plain version is K1's matvec arithmetic (bf16 input, exact nibbles, f32
    sums, zero-point term from the input's group sums), held to the dense
    dequantized product to 1e-4."""
    args = pk.case_inputs(name, "cpu")
    got = pk.CASES[name][1](*args)
    want = np.asarray(_jax_case(name, args))
    assert got.shape == want.shape and float(np.abs(want).max()) > 0.5
    tol = 1e-4 if name == "mv_small_n" else 1e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_probe_tool_case_on_the_cpu(capsys):
    """The tool's command line in this process (``--all`` starts a process a
    case, and runs on the card in chip_smoke.py): each case prints its value
    as the JAX script does."""
    for name in pk.CASES:
        assert pk.main(["--case", name, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == list(pk.CASES)
    assert all(": OK (" in ln and "plain version only" in ln for ln in lines)
    with pytest.raises(SystemExit):
        pk.main([])


@pytest.mark.parametrize("name", sorted(pk.CASES))
def test_probe_kernel_matches_plain(name):
    """Each CUDA probe against its plain version on the card, the whole
    output (tools.probe_kernels.TOL), one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    fn = pk.CASES[name][0]
    before = fn.launches
    r = pk.run_case(name, "cuda")
    assert fn.launches == before + 1
    assert np.isfinite(r["value"]) and r["max_abs_err"] <= pk.TOL[name][0] + 1e-6
