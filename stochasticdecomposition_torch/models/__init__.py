"""Problem instance library: classical SMPS instances, synthetic generators,
and the extensive-form cross-check oracle."""

from stochasticdecomposition_torch.models.instances import load_instance, INSTANCES  # noqa: F401
from stochasticdecomposition_torch.models.extensive import (  # noqa: F401
    enumerate_scenarios, solve_extensive_form,
)
from stochasticdecomposition_torch.models.synthetic import random_two_stage  # noqa: F401
