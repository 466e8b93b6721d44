"""Legacy simulation wrapper (counterpart of
``bayesianfiltering_tpu/legacy/simulation.py``)."""
from __future__ import annotations


class Simulation:
    """Holds a model rollout: ``Simulation(model, T, init_state)`` runs
    ``model.simulate`` and stores ``(states, observs)``; further keyword
    arguments (``generator``, ``draws``, ``params``) go to it."""

    def __init__(self, model, T: int, init_state, **kwargs):
        self.model = model
        self.states, self.observs = model.simulate(T, init_state, **kwargs)


__all__ = ["Simulation"]
