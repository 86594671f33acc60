"""A run with the timed path broken underneath comes out not correct, with
the cells' own limits: each fault that a cell can have, planted in the
program, on the CPU at a tiny size (the harness's look for a chip
skipped).  A sound run at the same size comes out correct."""

import pytest
import torch

import bench_tiny

GEN, FIT = "ffhq1024-gen-b8", "ffhq1024-fit-b1"
COLLECTION = bench_tiny.tiny_cell(FIT).traffic["collection"]


def test_sound_runs_are_correct():
    for cell in (GEN, FIT):
        line, _ = bench_tiny.run_tiny(cell)
        assert line["correct"], line["checks"]


def break_generate(monkeypatch, fault):
    from gan_segmentation_tpu_torch.train import generator as gmod

    real = gmod.FusedProgram.forward
    first = {}

    def forward(self, z, noise=None, generator=None):
        imgs, masks = real(self, z, noise=noise, generator=generator)
        if fault == "stale":       # the batch's state returned unchanged
            first.setdefault("out", (imgs.clone(), masks.clone()))
            return first["out"]
        imgs, masks = imgs.clone(), masks.clone()
        if fault == "half":        # half of the batch left out
            half = len(imgs) // 2
            imgs[half:] = 0
            masks[half:] = 0
        elif fault == "last_byte":  # each row's last packed byte reversed
            flip = torch.tensor([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                                dtype=torch.uint8)
            masks[..., -1] = flip[masks[..., -1].long()]
        else:                      # one answer altered where produced
            masks[0] = 255 - masks[0]
        return imgs, masks

    monkeypatch.setattr(gmod.FusedProgram, "forward", forward)


@pytest.mark.parametrize("fault", ["stale", "half", "altered", "last_byte"])
def test_generate_fault_is_not_correct(monkeypatch, fault):
    break_generate(monkeypatch, fault)
    line, judged = bench_tiny.run_tiny(GEN)
    assert not line["correct"], line["checks"]


def break_fit(monkeypatch, fault):
    from gan_segmentation_tpu_torch.train import solver as smod

    if fault in ("stale", "stops_later"):
        # a step that leaves the state unchanged: every step, or each step
        # after the first two epochs (a later replay that stops updating)
        real_step = torch.optim.Adam.step
        calls = []

        def step(self, closure=None):
            kept = [p.detach().clone() for g in self.param_groups
                    for p in g["params"]]
            real_step(self, closure)
            calls.append(1)
            if fault == "stale" or len(calls) > 2 * COLLECTION:
                with torch.no_grad():
                    for p, k in zip((p for g in self.param_groups
                                     for p in g["params"]), kept):
                        p.copy_(k)

        monkeypatch.setattr(torch.optim.Adam, "step", step)
        return
    if fault == "stale_feed":      # each epoch fed the epoch before's order
        real_orders = smod.SegSolver._epoch_orders

        def orders(self, n, epoch):
            return real_orders(self, n, max(epoch - 1, 0))

        monkeypatch.setattr(smod.SegSolver, "_epoch_orders", orders)
        return
    real_ce = smod.weighted_softmax_ce

    def ce(logits, labels, weight):
        if fault == "half":        # half of the batch left out
            h = labels.shape[1] // 2
            return real_ce(logits[:, :h], labels[:, :h], weight[:, :h])
        return real_ce(logits, labels, weight) * 1.001   # altered answer

    monkeypatch.setattr(smod, "weighted_softmax_ce", ce)


@pytest.mark.parametrize("fault", ["stale", "stops_later", "stale_feed",
                                   "half", "altered"])
def test_fit_fault_is_not_correct(monkeypatch, fault):
    break_fit(monkeypatch, fault)
    line, judged = bench_tiny.run_tiny(FIT)
    assert not line["correct"], line["checks"]
