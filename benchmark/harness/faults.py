"""Faults planted under the timed path, to show that the comparison sees
them: the readings that set each limit's upper end (benchmark/calibrate.py)
and the tests that see `correct` come out false (benchmark/tests/).

Each function takes the program's Trainer (as the entry has built its epoch
loop, `trainer.loop`) or Server and breaks it in place.
"""

from __future__ import annotations

import dataclasses


def frozen_state(trainer) -> None:
    """Every optimizer step returns the state unchanged."""
    for opt in (trainer.loop.opt_vae, trainer.loop.opt_gp):
        opt.step = lambda: False


def half_batch(trainer) -> None:
    """Each step leaves out half of its batch and takes the mean over the rest."""
    loop = trainer.loop
    half = loop.config.batch_size // 2
    loop.config = dataclasses.replace(loop.config, batch_size=half)
    steps = loop.epoch_steps

    def halved(*args):
        return [(pos[:half], w[:half], eps[:half]) for pos, w, eps in steps(*args)]

    loop.epoch_steps = halved


def altered_prediction(trainer) -> None:
    """The held-out predictions come back with their first image blank."""
    loop = trainer.loop
    oos = loop.oos

    def altered(Z):
        y, mse = oos(Z)
        y = y.clone()
        y[0] = 0.0
        return y, mse

    loop.oos = altered


def altered_answer(server) -> None:
    """Every reply comes back with its first image blank."""
    request = server.request

    def altered(d, q):
        y = request(d, q).copy()
        y[0] = 0.0
        return y

    server.request = altered


def half_answer(server) -> None:
    """Every reply leaves out the second half of its images."""
    request = server.request
    server.request = lambda d, q: request(d, q)[: max(1, len(d) // 2)]


TRAINING = {"frozen_state": frozen_state, "half_batch": half_batch,
            "altered_prediction": altered_prediction}
SERVING = {"altered_answer": altered_answer, "half_answer": half_answer}
