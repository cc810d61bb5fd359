import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for path in (os.path.join(ROOT, "src"), ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)

#: A study cut to what a CPU test holds: 2,000 people, a few scenarios, a
#: few days, a tau at which the epidemic takes off within them.
TINY_STUDY = {"twin.num_people": 2000, "config.tau": 4e-5,
              "traffic.tau_scales": [1.0, 1.2], "traffic.replicates": 2,
              "traffic.days": 12, "traffic.warmup_days": 1}


@pytest.fixture
def tiny():
    """The overrides that cut a cell to a CPU test's size."""
    return lambda workload: dict(TINY_STUDY)
