"""The yardstick's counts against hand counts at tiny shapes."""
import torch
from torch.utils.flop_counter import FlopCounterMode

from mcmcbench.lib import counts, inputs
from mcmcbench.reference import glm
from mcmcbench.tests import tiny


def test_dense_forward_flops_by_hand():
    sizes = dict(n_layers=2, d_model=8, n_heads=4, n_kv=2, head_dim=2, d_ff=12, vocab=10)
    b, s = 3, 5
    t = b * s
    proj = t * (8 * 8 + 2 * 8 * 4 + 8 * 8)  # q, k, v, o
    mlp = t * 3 * 8 * 12
    attn = 2 * b * 4 * s * s * 2  # QK^T and PV
    unembed = t * 8 * 10
    assert counts.dense_forward_flops(sizes, b, s) == 2 * (2 * (proj + mlp + attn) + unembed)


def test_dense_forward_flops_against_the_reference_forward():
    cell = tiny.lm_cell()
    sizes = inputs.dense_sizes(cell.config)
    params = inputs.draw_params(inputs.dense_layout(sizes, cell.config["assumed"]["init_std"]),
                                3, torch.device("cpu"), dtype=torch.float32)
    tokens = torch.randint(0, sizes["vocab"], (4, 9))
    with FlopCounterMode(display=False) as fc:
        glm.loglik(params, tokens, sizes)
    assert fc.get_total_flops() == counts.dense_forward_flops(sizes, 4, 8)


def test_pair_delta_bytes_by_hand():
    idx = torch.tensor([[0, 1, 2], [2, 3, 3], [9, 9, 9]])  # rows 0-3 and 9 (clamped to 7)
    k, m, d = 3, 3, 5
    rows = 5  # 0, 1, 2, 3, 7
    want = rows * (d * 4 + 4) + k * m * 4 + 2 * k * d * 4 + k * m * 4
    assert torch.unique(idx.clamp(0, 7)).numel() == rows
    assert counts.pair_delta_bytes((k, m), rows, d) == want
