"""The port's chained device timer (``utils/benchtime.py``) on the CPU,
against tests/test_benchtime.py's contract: no timed call repeats the
warm-up's inputs, the chain grows 4x until its long call dominates or it
reaches ``max_iters``, and ``return_valid`` gives ``(estimate, dominated)``.
The chaining is held by counting calls, never by a time (a CPU time is not
a device time); the card's replay of a captured chain is
``tests/test_torch_cuda.py::test_chained_device_time_replays_a_captured_b1_chain``.
"""

import pytest
import torch

from tfservingcache_tpu_torch.utils import benchtime


def _spy(monkeypatch, seconds=None):
    """Record (first element of args[0], chain length) of every chain the
    timer runs; with ``seconds(n)`` a chain reports that instead of its
    host time."""
    seen = []
    real = benchtime._eager_seconds

    def spy(fn, a0, rest, n):
        seen.append((float(a0.reshape(-1)[0]), n))
        t = real(fn, a0, rest, n)
        return t if seconds is None else seconds(n)

    monkeypatch.setattr(benchtime, "_eager_seconds", spy)
    return seen


@pytest.mark.parametrize("base", [1.0, 100.0])  # 100: f32 spacing ~7.6e-6
def test_timed_inputs_never_repeat_the_warm_up_inputs(monkeypatch, base):
    seen = _spy(monkeypatch)
    benchtime.chained_device_time(lambda x: x * 2.0, (torch.full((4,), base),),
                                  iters=4, repeats=2)
    per_round = 2 + 2 * 2  # 2 warm-ups, then repeats x (1-run, n-run)
    assert len(seen) % per_round == 0, seen
    warm, timed = set(), []
    for i in range(0, len(seen), per_round):
        warm.update(v for v, _ in seen[i:i + 2])
        timed.extend(v for v, _ in seen[i + 2:i + per_round])
    assert warm == {base}
    assert len(timed) >= 4 and all(t not in warm for t in timed)
    assert len(set(timed)) == len(timed)


def test_the_chain_grows_4x_until_it_dominates(monkeypatch):
    """A long call that never takes twice the short one grows the chain
    4, 16, 64, 256, 1000 (capped) and reports not dominated; one whose time
    grows with the chain stops at the first length."""
    seen = _spy(monkeypatch, seconds=lambda n: 1.0)
    est, dominated = benchtime.chained_device_time(
        lambda x: x + 1.0, (torch.ones(8),), iters=4, repeats=3, max_iters=1000,
        return_valid=True)
    assert sorted({n for _, n in seen}) == [1, 4, 16, 64, 256, 1000]
    assert dominated is False and est == pytest.approx(1e-9 / 999)
    seen = _spy(monkeypatch, seconds=lambda n: 0.5 + n)
    est, dominated = benchtime.chained_device_time(
        lambda x: x + 1.0, (torch.ones(8),), iters=4, repeats=3, return_valid=True)
    assert sorted({n for _, n in seen}) == [1, 4]
    assert dominated is True and est == pytest.approx(1.0)


def test_a_chain_of_n_makes_n_dependent_calls():
    """Each run gets the last one's input plus 1e-6 x its first output
    element: the calls see n distinct, growing inputs."""
    inputs = []

    def fn(x, y):
        inputs.append(float(x[0]))
        return (x * y, {"unused": x})

    acc = benchtime._chain(fn, torch.ones(3, dtype=torch.float64), (torch.tensor(2.0),), 5)
    assert len(inputs) == 5 and inputs == sorted(set(inputs))
    want, a = 0.0, 1.0
    for got in inputs:
        assert got == pytest.approx(a)
        want += 2 * a
        a += 2 * a * 1e-6
    assert float(acc) == pytest.approx(want)


def test_return_valid_gives_a_tuple_and_the_default_a_float():
    x = torch.ones(64, 64)
    est, dominated = benchtime.chained_device_time(lambda x: torch.tanh(x @ x), (x,), iters=8,
                                                   return_valid=True)
    assert isinstance(est, float) and est > 0 and isinstance(dominated, bool)
    assert isinstance(benchtime.chained_device_time(lambda x: x @ x, (x,), iters=4), float)


@pytest.mark.parametrize("bad", [torch.ones(4, dtype=torch.int32), [1.0, 2.0]])
def test_args0_must_be_a_floating_tensor(bad):
    with pytest.raises(TypeError, match="floating-point tensor"):
        benchtime.chained_device_time(lambda x: x, (bad,))


def test_a_bf16_input_is_perturbed_at_its_magnitude(monkeypatch):
    """bf16 at 100: a step of 8 eps x 100 survives the rounding, so the
    timed inputs still differ from the warm-up's."""
    seen = _spy(monkeypatch, seconds=lambda n: float(n))
    benchtime.chained_device_time(lambda x: x * 2, (torch.full((4,), 100.0,
                                                               dtype=torch.bfloat16),),
                                  iters=4, repeats=2)
    timed = [v for v, _ in seen[2:]]
    assert 100.0 not in timed and len(set(timed)) == len(timed)
