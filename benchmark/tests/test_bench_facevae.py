"""FaceVAE's reference module (reference/facevae.py), the two readers of
the VAE-convolution layer (vae_conv_roofline.train, vae_convs_per_step.train)
on stub runs, and the facevae128_train cell at a tiny size on the CPU."""

from __future__ import annotations

import types

import pytest
import torch
from conftest import ROOT  # noqa: F401
from test_bench_control import _control_passes, _run_with

from benchmark import run as brun
from benchmark.harness import faults, spans, trace
from benchmark.harness.manifest import Manifest
from benchmark.reference import facevae
from benchmark.yardstick import flops, peaks
from gppvae_tpu_torch.utils import timers
from gppvae_tpu_torch.utils.timers import Span

FULL = {"zdim": 256, "enc_features": [32] * 5, "dec_features": [32] * 5,
        "dec_upsample": "resize", "compute_dtype": "float32", "vae_layout": "facevae"}
SHAPES = {"n_train": 4119, "n_heldout": 542, "zdim": 256, "rank": 576, "batch_size": 64,
          "image_shape": (128, 128, 3)}


def test_the_flop_count_at_full_size():
    """Encoder direct, decoder in its least-MAC form (the module's
    docstring); the epoch as train_mfu prices it."""
    enc, dec = facevae.vae_flops(FULL, (128, 128, 3))
    assert (enc, dec) == (229_670_912, 164_793_344)
    s = {k: v for k, v in SHAPES.items() if k != "image_shape"}
    assert flops.epoch_flops(enc, dec, **s)["total"] == 5_970_829_611_520
    assert Manifest().config("facevae128_f32")["reference_module"].vae_flops(
        FULL, (128, 128, 3)) == (enc, dec)


def _stub_run(device_events: list, units: int):
    cfg = {"model": FULL, "reference_module": facevae}
    return types.SimpleNamespace(slice=trace.Slice(device_events, 9.0, units), shapes=SHAPES,
                                 cfg=cfg, host_slice=None)


def _kernel(name: str, ts: float, dur: float) -> dict:
    return {"cat": "kernel", "name": name, "ts": ts, "dur": dur}


def test_the_roofline_reader_prices_the_convolution_kernels_alone():
    names = ["sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw",
             "void cudnn::engines_precompiled::nhwcToNchwKernel<float, float>",
             "void DSE::regular_fft_pad<0, 1, 256>", "void fft2d_r2c_32x32<float>",
             "sm80_xmma_gemm_cf32cf32_f32f32_cf32_nt_n", "void wgrad_alg0_engine<float>",
             "sm90_xmma_dgrad_implicit_gemm_indexed", "void internal::region_transform_ABC"]
    other = ["void at::native::elementwise_kernel<128, 4>", "Memcpy DtoH (Device -> Pageable)",
             "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n", "upsample_nearest2d_nhwc_out_frame"]
    events = [_kernel(n, 100.0 * i, 50.0) for i, n in enumerate(names)]
    events += [_kernel(n, 5000.0 + 100.0 * i, 80.0) for i, n in enumerate(other)]
    reader = Manifest().reader("vae_conv_roofline.train")
    conv_s = len(names) * 50e-6 / 2
    parts = flops.epoch_flops(229_670_912, 164_793_344, zdim=256, n_train=4119, n_heldout=542,
                              batch_size=64, rank=576)
    work = parts["phase_a"] + parts["phase_c"] + parts["eval_oos"]
    want = 100.0 * work / conv_s / peaks.SPLIT_TF32_FLOPS
    assert reader(_stub_run(events, 2)) == pytest.approx(want)
    assert reader(_stub_run([_kernel(n, 0.0, 9.0) for n in other], 2)) is None
    assert reader(types.SimpleNamespace(slice=None)) is None


def _steps(n: int, per_step: int) -> list:
    """A C_minibatch of n steps, each crediting `per_step` to the counter
    under C.forward; then the host slice's epoch."""
    out = [Span("C_minibatch", -1, 0, 10 * n, {})]
    for i in range(n):
        step = len(out)
        out.append(Span("C.step", 0, 10 * i, 10 * i + 9, {}))
        out.append(Span("C.forward", step, 10 * i, 10 * i + 3, {"vae.conv3x3": per_step}))
    host = [s._replace(parent=s.parent + len(out) if s.parent >= 0 else -1) for s in out]
    return out + host


class _Run:
    """What the span readers read of a run: its two slices' units."""

    slice = types.SimpleNamespace(units=1)
    host_slice = types.SimpleNamespace(units=1)


def test_the_counter_reader_reads_convs_per_step_and_none_without_the_counter(monkeypatch):
    reader = Manifest().reader("vae_convs_per_step.train")
    run = _Run()
    spans._TAKEN[run] = _steps(3, 20)
    monkeypatch.setattr(timers.TRACER, "counts", {"vae.conv3x3": 60})
    assert reader(run) == 20.0
    # a program that never counts it (a version before the counter)
    monkeypatch.setattr(timers.TRACER, "counts", {"host_sync": 4})
    assert reader(run) is None
    monkeypatch.setattr(spans, "tracer", lambda: None)
    assert reader(run) is None


def test_a_tiny_facevae_cell_runs_traced_on_the_cpu(tiny):
    """The cell at the tiny tree's size (two stages: 4 + 4 convolutions a
    step); on the CPU the slice holds no device kernel, so the roofline is
    left out of the line."""
    out = brun.run_cell(tiny, "facevae128_train", 2**31 + 71, 0.2, True, torch.device("cpu"))
    assert out["correct"], out["checks"]
    m = out["metrics"]
    assert m["vae_convs_per_step.train"]["value"] == 8.0
    assert "vae_conv_roofline.train" not in m
    assert {"train_mfu", "c_sync_wait_ms.train", "encode_s.train"} <= set(m)


@pytest.mark.parametrize("fault", sorted(faults.TRAINING))
def test_a_training_fault_is_not_correct_in_the_facevae_cell(tiny, fault):
    assert not _run_with(tiny, "facevae128_train", fault)["correct"]


@pytest.mark.cuda
def test_the_tf32_control_is_not_correct_in_the_facevae_cell(tiny, card):
    assert not _control_passes(tiny, "facevae128_train", card)
