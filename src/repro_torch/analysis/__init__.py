from repro_torch.analysis.hlo import collective_bytes  # noqa: F401
from repro_torch.analysis.roofline import RooflineTerms, roofline_from_measurements  # noqa: F401
