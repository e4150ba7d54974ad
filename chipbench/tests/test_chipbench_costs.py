"""The benchmark's frozen work formulas against the program's own (its
kernels' ``report`` callbacks and parameter shapes) at today's shapes."""

import pytest

from chipbench import costs


@pytest.mark.parametrize("valid,used,d,f", [(32768, 8, 4096, 16384), (131072, 32, 1024, 512),
                                            (30000, 7, 4096, 16384)])
def test_ffn_launch_equals_the_programs(valid, used, d, f):
    from repro_torch.kernels.grouped_ffn.ops import ffn_cost

    assert costs.ffn_launch(valid, used, d, f) == pytest.approx(ffn_cost(valid, used, d, f, 2))


@pytest.mark.parametrize("b,h,hkv,s,dh", [(8, 32, 8, 2048, 128), (4, 32, 8, 4096, 128),
                                          (4, 16, 8, 4096, 64)])
def test_flash_launch_equals_the_programs(b, h, hkv, s, dh):
    from repro_torch.kernels.flash_attention.ops import flash_cost

    want = flash_cost((b, h, s, dh), b * hkv * s * dh, True, None, 0, s, 2)
    assert costs.flash_launch(b, h, hkv, s, dh) == pytest.approx(want)


@pytest.mark.parametrize("name", ["paper-moe-8e", "granite-moe-1b-a400m"])
def test_active_products_count_the_programs_parameters(name):
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe

    cfg = get_config(name)
    shapes = moe.param_shapes(cfg)
    blk = shapes["blocks"]
    per_expert = sum(blk[k][2] * blk[k][3] for k in ("wg", "wu", "wd"))
    attn = sum(v[1] * v[2] for v in blk["attn"].values())
    want = cfg.n_layers * (attn + blk["router"][1] * blk["router"][2] + cfg.top_k * per_expert)
    rcfg = dict(d_model=cfg.d_model, head_dim=cfg.head_dim, n_heads=cfg.n_heads,
                n_kv_heads=cfg.n_kv_heads, n_experts=cfg.n_experts, top_k=cfg.top_k,
                d_ff=cfg.d_ff, n_layers=cfg.n_layers, vocab=cfg.vocab)
    layers, head = costs.active_products(rcfg)
    assert layers == want and head == shapes["lm_head"][0] * shapes["lm_head"][1]
    # the train step's model FLOPs: 6 N D over these, plus the attention's
    b, s = 4, 4096
    assert costs.train_step_flops(rcfg, b, s) == pytest.approx(
        6 * (want + head) * b * s + 3 * cfg.n_layers * 4 * cfg.head_dim * b * cfg.n_heads
        * s * (s + 1) / 2)


def test_least_time_names_its_bound():
    assert costs.least_s(989e12, 1.0) == (pytest.approx(1.0), "compute")
    assert costs.least_s(1.0, 3.35e12) == (pytest.approx(1.0), "memory")
