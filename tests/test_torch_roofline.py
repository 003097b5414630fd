"""The port's parameter counts and model FLOPs (``roofline/params.py``,
``roofline/analysis.py``) against the JAX package's, for every arch at its
full config, and the reference's ``TestModelFlops``
(``tests/test_roofline.py:60``) and ``TestRooflineTerms`` (:34) on the
port, the latter over the H100's data-sheet constants.

The counts are exact integers, so they are held equal. ``param_count``
walks ``init_params`` on shapes alone: kimi-k2's 1.04 T parameters are
counted without a byte of weights.
"""
import dataclasses
import functools
import resource

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # leave the other test workers their cores
pytest.importorskip("jax")

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.roofline import analysis as jRA  # noqa: E402
from repro.roofline import params as jparams  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.roofline import analysis as RA  # noqa: E402
from repro_torch.roofline.params import active_param_count, param_count  # noqa: E402


@functools.lru_cache(maxsize=None)
def _jax_active(arch):
    return jparams.active_param_count(jget_config(arch))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_match_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert param_count(cfg) == jparams.param_count(jcfg)
    assert active_param_count(cfg) == _jax_active(arch)


def test_param_count_allocates_nothing():
    """kimi-k2 (about 1 T parameters, 2 TB in bf16) is counted on shapes
    alone: the process's peak resident memory grows by less than 1 GB."""
    cfg = get_config("kimi-k2-1t-a32b")
    param_count.cache_clear()
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss  # KiB on Linux
    n = param_count(cfg)
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    assert 0.8e12 < n < 1.3e12 and grown < 2 ** 20, (n, grown)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_jax(arch, monkeypatch):
    """Every ``INPUT_SHAPES`` entry; the reference's active count is cached
    across the shapes (its ``model_flops_estimate`` reads it at call time)."""
    monkeypatch.setattr(jparams, "active_param_count", lambda c: _jax_active(c.name))
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name, shape in INPUT_SHAPES.items():
        from repro.configs.base import INPUT_SHAPES as J_SHAPES

        assert RA.model_flops_estimate(cfg, shape) == jRA.model_flops_estimate(jcfg,
                                                                               J_SHAPES[name])


class TestModelFlops:
    """The reference's ``TestModelFlops`` on the port."""

    def test_dense_6nd(self):
        cfg = get_config("granite-20b")
        mf = RA.model_flops_estimate(cfg, INPUT_SHAPES["train_4k"])
        assert mf == pytest.approx(6.0 * param_count(cfg) * 256 * 4096)

    def test_moe_active_params(self):
        cfg = get_config("kimi-k2-1t-a32b")
        total, active = param_count(cfg), active_param_count(cfg)
        assert 0.8e12 < total < 1.3e12, total / 1e12  # ~1T
        assert 20e9 < active < 60e9, active / 1e9  # ~32B active

    def test_decode_counts_one_token(self):
        cfg = get_config("granite-20b")
        mf = RA.model_flops_estimate(cfg, INPUT_SHAPES["decode_32k"])
        assert mf == pytest.approx(2.0 * param_count(cfg) * 128)

    def test_enc_dec_and_vlm_as_the_reference_counts_them(self):
        """whisper's encoder and decoder together (70,680,576 parameters);
        llava with its projector (34,440,297,472), 2·N·D in prefill."""
        w, v = get_config("whisper-base"), get_config("llava-next-34b")
        assert param_count(w) == 70_680_576 and param_count(v) == 34_440_297_472
        mf = RA.model_flops_estimate(v, INPUT_SHAPES["prefill_32k"])
        assert mf == 2.0 * 34_440_297_472 * 32 * 32768


class TestRooflineTerms:
    """The reference's ``TestRooflineTerms`` over the NVIDIA H100 80GB HBM3
    (SXM, 700 W) data-sheet constants of ``launch/mesh.py``: 989 TFLOP/s
    dense bf16, 3.35 TB/s, NVLink 4 at 450 GB/s a direction."""

    def _r(self, **kw):
        base = dict(arch="a", shape="s", mesh="m", mode="syncdp", chips=256,
                    flops_per_chip=989e12, bytes_per_chip=3.35e12,
                    collective_bytes_per_chip=450e9, collectives={},
                    arg_bytes=0, temp_bytes=0, out_bytes=0, model_flops=0.0)
        base.update(kw)
        return RA.Roofline(**base)

    def test_unit_terms(self):
        r = self._r()
        assert r.t_compute == pytest.approx(1.0)
        assert r.t_memory == pytest.approx(1.0)
        assert r.t_collective == pytest.approx(1.0)

    def test_bottleneck_attribution(self):
        assert self._r(collective_bytes_per_chip=4.5e12).bottleneck == "collective"
        assert self._r(bytes_per_chip=4e13).bottleneck == "memory"
        assert self._r(flops_per_chip=1e16, bytes_per_chip=1e9,
                       collective_bytes_per_chip=1e9).bottleneck == "compute"

    def test_useful_ratio(self):
        r = self._r(model_flops=989e12 * 256 * 0.75)
        assert r.useful_flops_ratio == pytest.approx(0.75)

    def test_analyze_gives_one_card_and_no_collective(self):
        """``analyze`` over a trace's counts: one chip, no collective, and
        ``fits_one_card`` from the arguments and the peak (80 GB)."""
        cost = RA.TraceCost(flops=989e12, bytes_accessed=6.7e12, arg_bytes=60e9,
                            out_bytes=1e9, peak_bytes=20e9)
        r = RA.analyze(cost, arch="a", shape="s", mode="syncdp")
        assert (r.chips, r.mesh, r.collectives, r.collective_bytes_per_chip) == (1, "1", {}, 0.0)
        assert r.t_compute == pytest.approx(1.0) and r.t_memory == pytest.approx(2.0)
        assert r.bottleneck == "memory" and r.temp_bytes == 19e9 and r.fits_one_card
        assert not RA.analyze(dataclasses.replace(cost, peak_bytes=20e9 + 1), arch="a",
                              shape="s", mode="syncdp").fits_one_card
        assert "no collective" in r.notes and r.row()["fits_one_card"]

    def test_no_tpu_figure_is_the_cards(self):
        from repro_torch.launch import mesh

        assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW, mesh.LINK_BW) == (989e12, 3.35e12, 450e9)
        # no HLO to parse: the mesh program's collectives are counted as
        # they run (CollectiveCounter), summed by the reference's kinds
        assert RA.collective_bytes([]) == {k: 0 for k in RA.KINDS}
        assert RA.KINDS == ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                            "collective-permute")
