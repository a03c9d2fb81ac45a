"""The check's control and faults: each must come out as not correct.

The control is the plain reference one precision step below the
configuration's (``Reference(precision="control")``) put in the program's
place. The faults are planted in the port underneath a run that skips the
harness's look for a card: an answer altered where it is produced (the
matcher's translation moved by a metre), half of a batch left out (the
descriptor network run on the first half and its rows repeated), and a
stale state (``locate_fused`` answering every other query with the
previous answer). A run across chips has no exchange to leave out here:
every cell runs on one card."""

import pytest
import torch

import calibrate
from lbench import cell, check, spec


def _run(name, tiny, seed=9):
    return cell.run(name, seed, 0.4, False, "cpu", overrides=tiny,
                    log=lambda m: None)


@pytest.mark.parametrize("name", ["s2s-aligned-relocalize",
                                  "i2i-aligned-batch8"])
def test_control_is_not_correct(name, tiny):
    keep = {}
    line = cell.run(name, 4, 0.4, False, "cpu", overrides=tiny,
                    log=lambda m: None, keep=keep)
    assert line["correct"]
    readings = calibrate.control_readings(keep, 4, torch.device("cpu"))
    ok, table = check.verdict(readings, spec.load_cell(name).limits)
    assert not ok, table


def test_answer_altered_is_not_correct(tiny, monkeypatch):
    import gloc3d_tpu_torch.pipeline as pipeline

    real = pipeline.match_bev_topk

    def moved(*args, **kwargs):
        res = real(*args, **kwargs)
        xy_yaw = res.xy_yaw.clone()
        xy_yaw[..., 0] += 1.0
        return res._replace(xy_yaw=xy_yaw)

    monkeypatch.setattr(pipeline, "match_bev_topk", moved)
    line = _run("s2s-aligned-relocalize", tiny)
    assert not line["correct"]
    assert line["check"]["xy_gap_m"]["value"] > 0.5


def test_half_batch_is_not_correct(tiny, monkeypatch):
    from gloc3d_tpu_torch.models.descriptor import DescriptorModel

    real = DescriptorModel.forward

    def half(self, inputs, mask=None, voxel_stats=None):
        b = inputs.shape[0]
        h = (b + 1) // 2
        out = real(self, inputs[:h], None if mask is None else mask[:h],
                   voxel_stats)
        return torch.cat([out, out[:b - h]])

    monkeypatch.setattr(DescriptorModel, "forward", half)
    line = _run("i2i-aligned-batch8", tiny)
    assert not line["correct"]
    assert line["check"]["bank_gap"]["value"] > 0.1


def test_stale_answer_is_not_correct(tiny, monkeypatch):
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer

    real = GlobalLocalizer.locate_fused
    last = []

    def stale(self, *args, **kwargs):
        if last and len(last) % 2:
            last.append(last[-1])
            return last[-1]
        last.append(real(self, *args, **kwargs))
        return last[-1]

    monkeypatch.setattr(GlobalLocalizer, "locate_fused", stale)
    line = _run("s2s-aligned-relocalize", tiny)
    assert not line["correct"]
