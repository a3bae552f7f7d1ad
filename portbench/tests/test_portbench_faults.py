"""A whole run of each cell on the CPU (the look for a card skipped, the
sizes cut, float64), sound and with its timed path broken underneath: the
sound run comes out correct, and each fault the cell can have makes
``correct`` false. A cell of one chip has no exchange between chips to
leave out, and a cell of one lane no half of a batch."""
import pytest
import torch

from portbench.tests.helpers import small_run
from tramp_tpu_torch.parallel import MLVAMPSolver, SpectralVAMPSolver

CELLS = ["cs_glm_f64.lanes2048", "relu_net_f64.lanes2048",
         "relu_net_f64.single"]


def state_unchanged(monkeypatch):
    "A step that returns its state unchanged."
    vamp_step = SpectralVAMPSolver._step

    def vamp(self, model, carry, spectral=None):
        _, aux = vamp_step(self, model, carry, spectral)
        return carry, aux

    monkeypatch.setattr(SpectralVAMPSolver, "_step", vamp)
    monkeypatch.setattr(MLVAMPSolver, "_step",
                        lambda self, model, carry, inv=None: carry)


def _wrap_solve_info(monkeypatch, change):
    for cls in (SpectralVAMPSolver, MLVAMPSolver):
        plain = cls.solve_info

        def solve_info(self, model, plain=plain):
            return change(*plain(self, model))

        monkeypatch.setattr(cls, "solve_info", solve_info)


def half_left_out(monkeypatch):
    """Half of the batch left out: the second half of the lanes gets the
    first half's answers."""
    def change(post, n_iter, conv):
        B = n_iter.shape[0]
        h = B // 2

        def fill(x):
            x = x.clone()
            x[h:] = x[:B - h]
            return x
        post = {vid: {k: fill(v) for k, v in d.items()}
                for vid, d in post.items()}
        return post, fill(n_iter), fill(conv)
    _wrap_solve_info(monkeypatch, change)


def answer_altered(monkeypatch):
    "An answer altered where it is produced: one element of every lane's r."
    def change(post, n_iter, conv):
        post = {vid: dict(d) for vid, d in post.items()}
        r = post["x"]["r"].clone()
        r[..., 0] += 1.0
        post["x"]["r"] = r
        return post, n_iter, conv
    _wrap_solve_info(monkeypatch, change)


FAULTS = {"state_unchanged": state_unchanged,
          "half_left_out": half_left_out,
          "answer_altered": answer_altered}


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    result = small_run(workload)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_fault_makes_the_run_incorrect(workload, fault, monkeypatch):
    if fault == "half_left_out" and workload.endswith(".single"):
        pytest.skip("a cell of one lane has no half of a batch to leave out")
    FAULTS[fault](monkeypatch)
    torch.manual_seed(0)
    result = small_run(workload)
    assert not result["correct"], result["checks"]
