"""The operation and byte arithmetic against hand counts, and the model
FLOPs of the guided UNet evaluation against what the program runs."""

import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench import flops, harness, tiny
from gpubench.drivers import swap, train
from gpubench.reference import nets


def test_attention_call_by_hand():
    bh, n, m, d = 3, 16, 8, 4
    f, b = flops.attention_call(bh, n, m, d, "fwd")
    assert f == 2 * (2 * bh * n * m * d)  # Q K^T and P V
    assert b == 2 * bh * (n * d + m * d + m * d + n * d)  # Q, K, V read, O written, bf16
    f2, b2 = flops.attention_call(bh, n, m, d, "fwd_lse")
    assert (f2, b2) == (f, b + 4 * bh * n)
    fb, bb = flops.attention_call(bh, n, m, d, "bwd")
    assert fb == 2.5 * f
    assert bb == 2 * bh * (2 * n * d + 2 * m * d + n * d) + 4 * bh * n + 2 * bh * (n * d + 2 * m * d)
    assert flops.least_seconds(989e12, 0) == 1.0 and flops.least_seconds(0, 3.35e12) == 1.0


def test_count_by_hand():
    lin = nets.Linear(7, 5, device="meta")
    assert flops.count(lambda: lin(flops.meta(3, 7))) == 2 * 3 * 7 * 5
    conv = nets.Conv2d(4, 6, 3, padding=1, device="meta")
    assert flops.count(lambda: conv(flops.meta(2, 4, 5, 5))) == 2 * 2 * 6 * 5 * 5 * 4 * 9


def test_unet_self_attention_layers():
    cfg = json.loads((harness.HERE / "configs" / "reface_sd14_512.json").read_text())
    want = ([(4096, 40)] * 2 + [(1024, 80)] * 2 + [(256, 160)] * 2 + [(64, 160)]
            + [(256, 160)] * 3 + [(1024, 80)] * 3 + [(4096, 40)] * 3)
    assert flops.unet_self_attention_layers(cfg["unet"], 64) == want
    # a batch of 10: 50 steps of 10 K1 calls, the two VAE mid-blocks
    assert len(swap.attention_calls_per_batch(cfg, 10)) == 502
    tcfg = json.loads((harness.HERE / "configs" / "reface_sd14_512_train.json").read_text())
    # 2 encodes; 5 UNet passes x 10 layers x (2 forwards + 1 backward); decodes 5 + 2
    assert len(train.attention_calls_per_step(tcfg, 8)) == 2 + 5 * 10 * 3 + 7


def test_dedup_flops_are_the_programs():
    """One guided UNet evaluation: the reference's two rows less the dedup
    prefix count what the program's cfg_expand forward runs."""
    from reface_tpu_torch.pipelines.swap import FaceSwapper

    cfg = tiny.tiny_config("swap512_b10")
    sw = FaceSwapper(swap.program_config(cfg), device="cpu")
    h = cfg["latent_size"]
    with FlopCounterMode(display=False) as fc:
        sw.unet(torch.randn(1, 9, h, h), torch.zeros(1, dtype=torch.int32), torch.randn(2, 1, 768),
                cfg_expand=True)
    ref = swap.reference_meta(cfg)
    full = flops.count(lambda: ref.unet(flops.meta(2, 9, h, h), torch.zeros(2, dtype=torch.int32, device="meta"),
                                        flops.meta(2, 1, 768)))
    assert full - swap._dedup_prefix(ref.unet, cfg, h) == fc.get_total_flops()


def test_train_flops_are_the_programs_products():
    """The step's convolutions and dense products, with the recomputation
    of the rematerialised blocks, are the program's (the program also
    pools by matrix products, which are no model FLOPs)."""
    from reface_tpu_torch.pipelines.train import make_train_step

    from gpubench import inputs, weights

    cfg = tiny.tiny_config("train512_full_b8")
    step, _, init = make_train_step(*train.train_configs(cfg), device="cpu")
    state = init(weights.split_towers(weights.make_state(train.reference_meta(cfg), 0, "cpu",
                                                         train.program_dtypes(cfg)), train.TOWERS))
    b = 2
    with FlopCounterMode(display=False) as fc:
        step.loss_and_grads(state.modules, inputs.make_pairs(b, cfg["image_size"], 0, "cpu"),
                            train.make_draws(cfg, b, 0, "cpu"))
    got = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    ref = train.reference_meta(cfg).freeze()
    m, s, h = flops.meta, cfg["image_size"], cfg["latent_size"]
    rows = {"target": m(b, 3, s, s), "inpaint": m(b, 3, s, s), "mask": m(b, 1, s, s),
            "ref_clip224": m(b, 3, 224, 224), "landmarks": m(b, 136)}
    draws = {"t": torch.zeros(b, dtype=torch.long, device="meta"), "noise": m(b, 4, h, h),
             "drop": torch.zeros(b, dtype=torch.bool, device="meta"), "eps_target": m(b, 4, h, h),
             "eps_inpaint": m(b, 4, h, h)}
    with FlopCounterMode(display=False) as fc2:
        train.loss(ref, rows, m(b, 3, 224, 224), draws, b).backward()
    want = {str(k): v for k, v in fc2.get_flop_counts()["Global"].items()}
    for op in ("aten.convolution", "aten.convolution_backward", "aten.addmm"):
        assert got[op] == want[op], op
    assert train.flops_per_step(cfg, b) == sum(want.values())
