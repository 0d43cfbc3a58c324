"""The check's power, at a tiny size on the CPU: a sound run is correct;
the control (the reference in bfloat16 in the program's place) and each
fault a cell can have, planted under the timed path, are not.  The cells
run on one card, so no exchange between cards can be left out."""

import pytest
import torch

import tiny


def _ensemble_step_unchanged(monkeypatch):
    import hybrid9_tpu_torch.ensemble as ens
    step = ens.day_step

    def unchanged(state, *a, **kw):
        return state, step(state, *a, **kw)[1]
    monkeypatch.setattr(ens, "day_step", unchanged)


def _assimilate_step_unchanged(monkeypatch):
    import hybrid9_tpu_torch.assimilate as da
    step = da.day_step

    def unchanged(state, *a, **kw):
        return state, step(state, *a, **kw)[1]
    monkeypatch.setattr(da, "day_step", unchanged)


def _ensemble_half_left_out(monkeypatch):
    """Half of the cells computed, the other half given their mean."""
    import hybrid9_tpu_torch.ensemble as ens
    whole = ens.run_ensemble_annual

    def half(*a, **kw):
        out = whole(*a, **kw)
        for v in out.values():
            h = v.shape[1] // 2
            v[:, h:] = v[:, :h].mean(dim=1, keepdim=True)
        return out
    monkeypatch.setattr(ens, "run_ensemble_annual", half)


def _assimilate_half_left_out(monkeypatch):
    import hybrid9_tpu_torch.assimilate as da
    whole = da.assimilate

    def half(*a, **kw):
        out = whole(*a, **kw)
        for k in ("theta_mean", "theta_std"):
            h = out[k].shape[0] // 2
            out[k][h:] = out[k][:h].mean()
        return out
    monkeypatch.setattr(da, "assimilate", half)


def _answer_altered(monkeypatch):
    """The day's ET of every cell 5 % high where the hydrology day makes
    it."""
    import hybrid9_tpu_torch.step as step
    day = step.hydrology_day

    def altered(*a, **kw):
        soil, diags = day(*a, **kw)
        return soil, dict(diags, evap_day=diags["evap_day"] * 1.05)
    monkeypatch.setattr(step, "hydrology_day", altered)


FAULTS = {
    "ens8_nl8": [_ensemble_step_unchanged, _ensemble_half_left_out,
                 _answer_altered],
    "da16_nl8": [_assimilate_step_unchanged, _assimilate_half_left_out,
                 _answer_altered],
}


@pytest.mark.parametrize("cell", ["ens8_nl8", "ens8_clm10", "da16_nl8"])
def test_sound_run_is_correct(cell):
    out = tiny.run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("cell,fault", [
    (cell, f) for cell, fs in FAULTS.items() for f in fs],
    ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = tiny.run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["ens8_nl8", "da16_nl8"])
def test_control_is_not_correct(cell):
    from h9bench import harness, traffic

    _, config, workload, limits = tiny.cell(cell)
    c = traffic.KINDS[workload["kind"]](config, workload, tiny.SEED,
                                        torch.device("cpu"))
    got = harness.control_check(c, limits, tiny.SEED, "bfloat16")
    assert not harness.passed(got["checks"]), got
