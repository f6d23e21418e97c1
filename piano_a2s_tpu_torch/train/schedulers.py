"""Learning-rate scheduling, a copy of piano_a2s_tpu/train/schedulers.py:
NewBob annealing on a validation metric
(speechbrain.nnet.schedulers.NewBobScheduler semantics; configured at
reference hparams/pretrain.yaml:104-108) and the exponential
teacher-forcing-ratio decay (reference: pretrain.py:149-153)."""

from __future__ import annotations

import dataclasses
from typing import List, Tuple


@dataclasses.dataclass
class NewBobScheduler:
    initial_value: float
    annealing_factor: float = 0.8
    improvement_threshold: float = 0.0025
    patient: int = 0

    def __post_init__(self):
        self.hyperparam_value = self.initial_value
        self.metric_values: List[float] = []
        self.current_patient = self.patient

    def __call__(self, metric_value: float) -> Tuple[float, float]:
        """Returns (old_value, new_value); anneals when relative improvement
        over the previous metric is below the threshold."""
        old_value = new_value = self.hyperparam_value
        if self.metric_values:
            prev = self.metric_values[-1]
            improvement = (prev - metric_value) / prev if prev != 0 else 0.0
            if improvement < self.improvement_threshold:
                if self.current_patient == 0:
                    new_value = old_value * self.annealing_factor
                    self.current_patient = self.patient
                else:
                    self.current_patient -= 1
        self.metric_values.append(metric_value)
        self.hyperparam_value = new_value
        return old_value, new_value

    def state_dict(self) -> dict:
        return {"hyperparam_value": self.hyperparam_value,
                "metric_values": list(self.metric_values),
                "current_patient": self.current_patient}

    def load_state_dict(self, state: dict) -> None:
        self.hyperparam_value = state["hyperparam_value"]
        self.metric_values = list(state["metric_values"])
        self.current_patient = state["current_patient"]


def teacher_forcing_ratio(base: float, decay: float, epoch: int) -> float:
    """tf_ratio = base * decay**epoch (reference: pretrain.py:151)."""
    return base * decay ** epoch
