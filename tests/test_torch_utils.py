"""The port's framework-free utilities against the originals.

`gppvae_tpu_torch/utils/flops.py` is the port's own copy of
`gppvae_tpu/utils/flops.py` (the port imports nothing of the JAX package):
every public function is held equal to the original over the widths the
repo supports. `utils/timers.PhaseTimer` keeps the original's `phase` /
`reset` and adds the device synchronize.
"""

import inspect
import time

import pytest
import torch

from gppvae_tpu.utils import flops as jflops
from gppvae_tpu.utils.timers import PhaseTimer as JaxPhaseTimer
from gppvae_tpu_torch.train import device as train_device
from gppvae_tpu_torch.utils import flops
from gppvae_tpu_torch.utils.timers import PhaseTimer

ARCHS = [  # image_shape, enc_features, dec_features, zdim
    ((32, 32, 1), (32, 64, 128), (128, 64, 32), 16),  # rotated digits, published widths
    ((128, 128, 3), (32, 64, 128), (128, 64, 32), 32),  # face views
    ((32, 32, 1), (8, 16), (16, 8), 6),  # the tests' golden size
    ((20, 12, 2), (4,), (4,), 3),  # odd sizes: the stride-2 SAME rounding
]
PUBLIC = sorted(n for n, f in vars(jflops).items()
                if inspect.isfunction(f) and not n.startswith("_"))


def test_flops_copy_has_the_originals_public_functions():
    ours = sorted(n for n, f in vars(flops).items()
                  if inspect.isfunction(f) and not n.startswith("_"))
    assert ours == PUBLIC == ["decoder_fwd_flops", "encoder_fwd_flops", "format_tflops",
                              "gp_solve_flops", "gppvae_epoch_flops", "vae_epoch_flops"]
    for name in PUBLIC:
        assert (inspect.signature(getattr(flops, name))
                == inspect.signature(getattr(jflops, name))), name


@pytest.mark.parametrize("arch", ARCHS, ids=lambda a: "x".join(map(str, a[0])))
@pytest.mark.parametrize("upsample", ["resize", "subpixel"])
def test_flops_equal_the_original(arch, upsample):
    shape, enc, dec, zdim = arch
    assert flops.encoder_fwd_flops(shape, enc, zdim) == jflops.encoder_fwd_flops(shape, enc, zdim)
    assert (flops.decoder_fwd_flops(shape, dec, zdim, upsample)
            == jflops.decoder_fwd_flops(shape, dec, zdim, upsample))
    kw = dict(image_shape=shape, enc_features=enc, dec_features=dec, zdim=zdim,
              batch_size=128, upsample=upsample)
    g = dict(kw, n_train=5700, n_heldout=400, rank=56)
    assert flops.gppvae_epoch_flops(**g) == jflops.gppvae_epoch_flops(**g)
    assert flops.gppvae_epoch_flops(**g)["total"] == sum(
        v for k, v in flops.gppvae_epoch_flops(**g).items() if k != "total")
    v = dict(kw, n_train=5700, n_val=300)
    assert flops.vae_epoch_flops(**v) == jflops.vae_epoch_flops(**v)


@pytest.mark.parametrize("n,r,l", [(5700, 56, 16), (332, 232, 32), (5700, 560, 16), (1, 1, 1)])
def test_gp_solve_flops_and_format_equal_the_original(n, r, l):
    assert flops.gp_solve_flops(n, r, l) == jflops.gp_solve_flops(n, r, l)
    assert flops.format_tflops(flops.gp_solve_flops(n, r, l)) == jflops.format_tflops(
        jflops.gp_solve_flops(n, r, l))


def test_phase_timer_keeps_the_originals_interface():
    """phase() accumulates per name (also when the body raises), reset()
    hands the totals over and starts anew, as the JAX package's timer; the
    trainers' import path still resolves to the moved class."""
    assert train_device.PhaseTimer is PhaseTimer
    ours, theirs = PhaseTimer(torch.device("cpu")), JaxPhaseTimer()
    for t in (ours, theirs):
        with t.phase("a"):
            time.sleep(0.002)
        with t.phase("a"):
            pass
        with pytest.raises(KeyError), t.phase("b"):
            raise KeyError("x")
        assert set(t.totals) == {"a", "b"} and t.totals["a"] >= 0.002
        out = t.reset()
        assert set(out) == {"a", "b"} and t.totals == {}
    assert PhaseTimer().device.type == "cpu"
