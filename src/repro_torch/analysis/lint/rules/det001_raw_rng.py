"""DET001: raw RNG use outside the counter-RNG module.

The port's reproducibility contract makes every stochastic draw a pure
function of ``(seed, day, entity ids, stream)`` through ``core/rng.py``, the
reference's hash carried in int64: that is what makes a run bitwise equal
on every layout, after every restore, and between a kernel and its plain
version. A draw from torch's global or explicit generators
(``torch.rand*``, ``randn``, ``randint``, ``randperm``, ``bernoulli``,
``multinomial``, ``normal``, the in-place ``Tensor.uniform_`` family), a
reseed (``torch.manual_seed``, ``torch.Generator``), or numpy's and the
standard library's ``random`` brings back an order- or device-dependent
stream: the CPU and CUDA generators give different numbers for one seed.
Host builders that deliberately draw from a *seeded* generator (synthetic
populations, the chaos harness, random model weights) carry a pragma with
their reason.
"""

from __future__ import annotations

import ast

_BANNED_MODULES = ("jax.random", "numpy.random", "random", "torch.random")
_BANNED_PREFIXES = tuple(m + "." for m in _BANNED_MODULES) + ("torch.cuda.random.",)
#: torch functions that draw from, or reseed, a generator
_TORCH_DRAWS = {
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like", "randperm",
    "bernoulli", "multinomial", "normal", "poisson", "Generator", "manual_seed", "seed",
    "initial_seed", "cuda.manual_seed", "cuda.manual_seed_all", "cuda.seed",
    "cuda.seed_all",
}
#: in-place Tensor methods that fill from a generator
_TENSOR_DRAWS = {"uniform_", "normal_", "random_", "exponential_", "bernoulli_",
                 "cauchy_", "log_normal_", "geometric_"}


class RawRngRule:
    code = "DET001"
    description = ("raw torch / numpy / random RNG use outside core/rng.py "
                   "(draws must go through the counter-RNG streams)")

    def check(self, ctx):
        if ctx.tree is None or ctx.endswith(ctx.config.rng_module_suffix):
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name in _BANNED_MODULES:
                        yield ctx.finding(self.code, node, f"import of '{a.name}': all "
                                          "stochastic draws must go through repro_torch."
                                          "core.rng streams")
            elif isinstance(node, ast.ImportFrom):
                if node.level == 0 and node.module in _BANNED_MODULES:
                    yield ctx.finding(self.code, node, f"import from '{node.module}': all "
                                      "stochastic draws must go through repro_torch."
                                      "core.rng streams")
            elif isinstance(node, ast.Call):
                name = ctx.imports.resolve(node.func)
                f = node.func
                if name and (name in _BANNED_MODULES or name.startswith(_BANNED_PREFIXES)
                             or name.startswith("torch.")
                             and name[len("torch."):] in _TORCH_DRAWS):
                    yield ctx.finding(self.code, node, f"call to '{name}': use "
                                      "repro_torch.core.rng (counter-based, the same on "
                                      "every device and layout) instead")
                elif isinstance(f, ast.Attribute) and f.attr in _TENSOR_DRAWS:
                    yield ctx.finding(self.code, node, f"in-place generator fill "
                                      f"'.{f.attr}()': use repro_torch.core.rng instead")
