"""RANDOM tensors (``rand``): the contract both packages keep.

The JAX package draws each RANDOM tensor from
``fold_in(PRNGKey(seed), tid)``; the port seeds one generator per
``(seed, tid)`` (``exprgrad_torch.backend.executor.random_seed``).  The
streams differ between the packages, so nothing here compares values
across them.  What both keep, and what these tests pin in each:

* a tensor's values do not depend on which other RANDOM tensors its
  target holds: a program holding two gives each the values of a program
  with the same tid that holds only it;
* the values depend on the run's seed and on the tid;
* they lie in ``[lo, hi)``.

The port runs on the CPU, the JAX package through ``backend="jax"`` on
the CPU.
"""

import numpy as np
import pytest

import exprgrad_torch as egt
import exprgrad_tpu
from exprgrad_torch.backend.executor import random_seed

PACKAGES = {
    "torch": (egt, dict(device="cpu")),
    "jax": (exprgrad_tpu, dict(backend="jax")),
}
RANGES = ((-2.0, 3.0), (5.0, 7.0))
ROWS = 64


def _program(m, draw, ranges=RANGES):
    """``out[:, j]`` is RANDOM tensor j, or 0 where ``draw`` leaves it
    out.  Tensor 0 has tid 2 and tensor 1 tid 3 in every variant: where
    tensor 0 is left out, a RESULT takes its tid."""
    x = m.input("x")
    i = m.iters("i")
    if draw == "second":
        first = m.Fun("h")
        first[i] = x[i] * 0.0
    else:
        first = m.rand(x, ranges[0])
    out = m.Fun("out").with_shape([x.shape[0], 2])
    out[i, 0] = first[i]
    if draw == "first":
        out[i, 1] = x[i] * 0.0
    else:
        out[i, 1] = m.rand(x, ranges[1])[i]
    return out.target("out")


def _draw(package, draw, seed=0, ranges=RANGES):
    m, kw = PACKAGES[package]
    model = m.compile(_program(m, draw, ranges), seed=seed, **kw)
    kinds = [t.kind.name for t in model.program.tensors]
    random = [tid for tid, kind in enumerate(kinds) if kind == "RANDOM"]
    want = {"first": [2], "second": [3], "both": [2, 3]}[draw]
    assert random == want, kinds
    return np.asarray(model.call("out", {"x": np.zeros(ROWS, np.float32)}))


@pytest.mark.parametrize("package", sorted(PACKAGES))
@pytest.mark.parametrize("alone", ["first", "second"])
def test_values_do_not_depend_on_the_other_random_tensors(package, alone):
    both = _draw(package, "both")
    col = 0 if alone == "first" else 1
    np.testing.assert_array_equal(_draw(package, alone)[:, col],
                                  both[:, col])


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_values_lie_in_their_range(package):
    out = _draw(package, "both")
    for col, (lo, hi) in enumerate(RANGES):
        assert np.all((out[:, col] >= lo) & (out[:, col] < hi)), col
        # uniform over the range, not a corner of it
        assert out[:, col].max() - out[:, col].min() > 0.5 * (hi - lo)


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_values_depend_on_seed_and_tid(package):
    same = ((0.0, 1.0), (0.0, 1.0))
    a = _draw(package, "both", seed=0, ranges=same)
    b = _draw(package, "both", seed=1, ranges=same)
    again = _draw(package, "both", seed=0, ranges=same)
    np.testing.assert_array_equal(a, again)
    assert not np.any(a == b)  # another seed: every value differs
    assert not np.any(a[:, 0] == a[:, 1])  # another tid, the same range


def test_random_seed_hashes_the_pair():
    seeds = {random_seed(s, t) for s in range(8) for t in range(8)}
    assert len(seeds) == 64
    assert random_seed(3, 5) == random_seed(3, 5)
    assert random_seed(-1, 0) == random_seed(2**64 - 1, 0)
