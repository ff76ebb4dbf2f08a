"""The KWS cell at the CPU tests' size: inputs, reference, arithmetic, and
whole runs (sound, the control, and the timed path broken underneath)."""
from __future__ import annotations

import json

import numpy as np
import pytest

from portbench import harness, roofline
from portbench.inputs import kws as kws_inputs
from portbench.tests import _cells

ref = harness.load_reference("pscnn_kws")
LAYERS = harness.load_config(harness.manifest(), "pscnn_kws")["layers"]


def test_model_and_audio_repeat_for_a_seed_and_differ_across():
    w1, t1 = kws_inputs.random_model(LAYERS, 7, {"input_duty": 0.75,
                                                 "z": [2.6, 3.6],
                                                 "fc_thr": 400})
    w2, t2 = kws_inputs.random_model(LAYERS, 7, {"input_duty": 0.75,
                                                 "z": [2.6, 3.6],
                                                 "fc_thr": 400})
    w3, _ = kws_inputs.random_model(LAYERS, 8, {"input_duty": 0.75,
                                                "z": [2.6, 3.6],
                                                "fc_thr": 400})
    assert all(np.array_equal(w1[k], w2[k]) for k in w1)
    assert all(np.array_equal(t1[k][0], t2[k][0]) for k in t1)
    assert any(not np.array_equal(w1[k], w3[k]) for k in w1)
    big = 2 ** 31 + 12345
    a, b = kws_inputs.audio_bank(big, 9, 512), kws_inputs.audio_bank(big, 9,
                                                                     512)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, kws_inputs.audio_bank(big + 1, 9, 512))


def test_streams_read_their_own_rows_of_the_bank():
    bank = kws_inputs.audio_bank(3, 11, 4)
    n, prime = 5, 3
    first = kws_inputs.first_push(bank, n, prime)
    rounds = [kws_inputs.round_chunks(bank, j, n) for j in range(2, 6)]
    for sid in range(n):
        fed = np.concatenate([first[sid]] + [r[sid] for r in rounds])
        assert np.array_equal(
            fed, kws_inputs.stream_audio(bank, sid, n, prime, 5))
    assert len({bytes(r) for r in rounds[0]}) == n


def _tiny(thr=0, flip=False, pool=1):
    layers = [{"type": "conv", "name": "l0", "cin": 1, "cout": 1, "k": 3,
               "stride": 1, "pad": 1, "pool": pool, "in_bits": 8,
               "in_offset": 128},
              {"type": "gap", "name": "gap", "channels": 1, "saturate": 255},
              {"type": "fc", "name": "fc", "cin": 1, "cout": 2,
               "in_bits": 8, "in_offset": 0, "out_raw": True}]
    weights = {0: np.array([[1], [0], [-1]], np.int8),
               2: np.array([[1, -1]], np.int8)}
    thresholds = {0: (np.array([thr], np.float64), np.array([flip]))}
    return layers, weights, thresholds


def test_reference_on_hand_checked_cases():
    audio = np.array([130, 128, 120, 140], np.uint8)
    # x - 128 = [2, 0, -8, 12], zero-padded; acc_t = x[t-1] - x[t+1]:
    # [0, 10, -12, -8]
    out = ref.forward(*_tiny(thr=0), audio)
    assert out["gap"].tolist() == [2] and out["logits"].tolist() == [2, -2]
    assert ref.forward(*_tiny(thr=1), audio)["logits"].tolist() == [1, -1]
    assert ref.forward(*_tiny(thr=0, flip=True), audio)["logits"].tolist() \
        == [2, -2]
    # OR-pool over [1, 1, 0, 0] -> [1, 0]
    assert ref.forward(*_tiny(thr=0, pool=2), audio)["gap"].tolist() == [1]
    # 4-bit inputs: codes [128, 128, 112, 128] -> acc [0, 16, 0, -16]
    assert ref.forward(*_tiny(thr=0), audio, input_bits=4)["gap"].tolist() \
        == [3]
    # the GAP counter saturates at 255
    long = np.full(600, 128, np.uint8)
    assert ref.forward(*_tiny(thr=0), long)["gap"].tolist() == [255]
    post = ref.posteriors(np.array([2, -2]))
    assert post.dtype == np.float32 and abs(post.sum() - 1) < 1e-6


def test_reference_equals_the_offline_program_on_an_utterance():
    import torch

    from repro_torch.models.kws import offline_logits

    from portbench.drivers.kws_stream import port_spec
    cfg = json.loads((_cells.DATA / "pscnn_kws_smoke.json").read_text())
    w, t = kws_inputs.random_model(cfg["layers"], 5, cfg["random_model"])
    audio = kws_inputs.audio_bank(5, 4, 512).reshape(-1)
    got = offline_logits(port_spec(cfg), w, t, torch.as_tensor(audio),
                         device="cpu")
    assert ref.forward(cfg["layers"], w, t, audio)["logits"].tolist() == \
        got.tolist()


@pytest.mark.parametrize("spec_name", ["full", "smoke"])
def test_stream_geometry_matches_the_scheduler_plan(spec_name):
    from repro_torch.models.kws import build_kws_smoke_spec, build_kws_spec
    from repro_torch.stream.state import plan_stream

    spec = build_kws_spec() if spec_name == "full" else \
        build_kws_smoke_spec()
    layers = LAYERS if spec_name == "full" else json.loads(
        (_cells.DATA / "pscnn_kws_smoke.json").read_text())["layers"]
    plan = plan_stream(spec, hop_frames=8)
    length = plan.prime_samples + 9 * plan.hop_samples
    geo = roofline.kws_geometry(layers, length, plan.hop_samples)
    for g, st in zip(geo, plan.convs):
        assert (g["n_conv"], g["flush"], g["tail"], g["phase"]) == \
            (st.n_conv, st.flush_conv, st.tail, st.phase)


def test_hop_arithmetic_against_the_spec_total_macs():
    from repro_torch.models.kws import build_kws_spec

    hop, prime = 512, 112
    fc = sum(l["cin"] * l["cout"] for l in LAYERS if l["type"] == "fc")
    for k in (3, 10, 31):
        length = prime + k * hop
        whole = build_kws_spec(in_len=length).total_macs
        before = build_kws_spec(in_len=length - hop).total_macs
        assert roofline.kws_hop_macs(LAYERS, length, hop, emit=False) == \
            whole - before
        # what an emit hop adds: the flush positions and the fc cascade
        flush = sum(g["flush"] * g["k"] * g["cin"] * g["cout"]
                    for g in roofline.kws_geometry(LAYERS, length, hop))
        assert roofline.kws_hop_macs(LAYERS, length, hop) == \
            whole - before + flush + fc
    assert roofline.kws_state_values(LAYERS, prime + 4 * hop, hop) == \
        17 + 2 * 64 + 4 * 128 + 2 * 256 + 352 + 352
    bound, term = roofline.kws_hop_bound_s(LAYERS, prime + 4 * hop, hop,
                                           8192)
    assert term == "operations" and 1e-4 < bound < 2e-4


def test_a_sound_run_is_correct_and_prints_every_metric():
    out, checks = _cells.run_small("kws_saturated")
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"audio_s_per_s", "hop_p95_ms", "setup_s"}
    assert checks["logit_mismatch"]["value"] == 0


def test_the_control_is_not_correct():
    wl, config, traffic = _cells.small("kws_saturated")
    from portbench.drivers import kws_stream

    cell = kws_stream.Cell(config, traffic, 99, "cpu",
                           harness.load_limits(wl["name"]))
    cell.setup()
    cell.window(0.2)      # exact: any count of rounds serves
    cell.release()
    assert harness.checks_pass(cell.check(ref))
    assert not harness.checks_pass(cell.check(ref, control=True))


def _patch_step(monkeypatch, change):
    from repro_torch.stream import scheduler

    orig = scheduler._BatchedModel.step

    def step(self, audio, mask, tails, pendings, gap, *rest, emit,
             out=None):
        return change(orig, self, audio, mask, tails, pendings, gap, *rest,
                      emit=emit, out=out)
    monkeypatch.setattr(scheduler._BatchedModel, "step", step)


def _unchanged(orig, self, audio, mask, tails, pendings, gap, *rest, emit,
               out):
    res = orig(self, audio, mask, tails, pendings, gap, *rest, emit=emit,
               out=out)
    return (tuple(tails), tuple(pendings), gap, *res[3:])


def _half(orig, self, audio, mask, tails, pendings, gap, *rest, emit, out):
    mask = mask.clone()
    mask[mask.shape[0] // 2:] = False
    return orig(self, audio, mask, tails, pendings, gap, *rest, emit=emit,
                out=out)


def _altered(orig, self, audio, mask, tails, pendings, gap, *rest, emit,
             out):
    res = list(orig(self, audio, mask, tails, pendings, gap, *rest,
                    emit=emit, out=out))
    if emit:
        res[3] = res[3].clone()
        res[3][:, 0] += 1
    return tuple(res)


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["state_unchanged", "half_the_batch",
                              "answer_altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    _patch_step(monkeypatch, fault)
    out, checks = _cells.run_small("kws_saturated")
    assert not out["correct"]
    assert checks["logit_mismatch"]["value"] > 0
