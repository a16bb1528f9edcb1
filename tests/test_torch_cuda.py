"""Tests of the port that need a CUDA card: the CUDA kernels against their
plain versions, the wrappers' refusals on card tensors, and the engine on
the card against the CPU. Without a card they skip. This file imports
nothing of JAX, so it also runs where only the port is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.models.transformer import RuntimeOpts
from repro_torch.params import init_params
from repro_torch.serving.engine import Engine

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(device, b=2, kh=2, g=6, hd=64, s=600, seed=10):
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(b, kh, g, hd)).astype(np.float32),
              rng.integers(-127, 128, (b, kh, s, hd)).astype(np.int8),
              rng.uniform(1e-3, 2e-2, (b, kh, s)).astype(np.float32),
              rng.integers(-127, 128, (b, kh, s, hd)).astype(np.int8),
              rng.uniform(1e-3, 2e-2, (b, kh, s)).astype(np.float32),
              np.tile(np.arange(s, dtype=np.int32), (b, 1)))
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
def test_decode_attention_kernel_matches_plain_version(cuda_device, qdtype):
    """G = 6, S no multiple of any tile, per-row q_pos with a fully masked
    row; f32 math in another order, so 1e-4 absolute."""
    args = _inputs(cuda_device)
    args[0] = args[0].to(getattr(torch, qdtype))
    q_pos = torch.tensor([450, -1], dtype=torch.int32, device=cuda_device)
    before = da.decode_attention.launches
    got = ops.decode_attention(*args, q_pos)
    assert da.decode_attention.launches == before + 1
    want = da.decode_attention_ref(*args, q_pos)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=1e-4)


def test_decode_attention_refuses_bad_card_input(cuda_device):
    args = _inputs(cuda_device, s=64)
    q_pos = torch.tensor(10, dtype=torch.int32, device=cuda_device)
    before = da.decode_attention.launches
    bad = [
        (args[:1] + [args[1].transpose(2, 3).contiguous().transpose(2, 3)]
         + args[2:], q_pos),  # non-contiguous codes
        (args, q_pos.to(torch.int64)),  # q_pos dtype
        (args, 10),  # a host int would sync the decode loop
        ([args[0][..., :48].contiguous()] + args[1:], q_pos),  # hd mismatch
    ]
    for a, qp in bad:
        with pytest.raises(ValueError):
            da.decode_attention(*a, qp)
    assert da.decode_attention.launches == before


def test_engine_on_card_matches_cpu(cuda_device):
    """llama2-7b tiny, same weights, int8 KV: greedy tokens on the card
    equal the CPU's, and every decode step launches the kernel once per
    layer."""
    cfg = get_config("llama2-7b-tiny")
    opts = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8))
    want = Engine(cfg, params, opts, cache_len=32,
                  device="cpu").generate(prompts, 6)
    before = da.decode_attention.launches
    got = Engine(cfg, params, opts, cache_len=32,
                 device=cuda_device).generate(prompts, 6)
    assert da.decode_attention.launches - before == cfg.num_layers * 5
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logprobs, want.logprobs, rtol=1e-3,
                               atol=1e-3)
