from repro_torch.data.synthetic import (  # noqa: F401
    grid_population,
    watts_strogatz_population,
)
from repro_torch.data.digital_twin import digital_twin_population  # noqa: F401
