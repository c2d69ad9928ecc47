"""The port's public surface against the JAX package's, by an AST walk of
both: every public function, class, method and upper-case module constant
of the JAX modules below has a namesake in the port's module, apart from
the names ROADMAP.md records as deliberate (`DELIBERATE`)."""

import ast
import glob
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX module → the port's, relative to each package
MODULES = {"ops/entropy.py": "ops/entropy.py", "kernels/base.py": "kernels/base.py",
           "models/likelihoods.py": "models/likelihoods.py",
           "native/__init__.py": "native.py",
           **{f"{pkg}/{os.path.basename(p)}": f"{pkg}/{os.path.basename(p)}"
              for pkg in ("data", "portfolio", "parallel")
              for p in glob.glob(os.path.join(REPO, "portfoliooptgp_tpu", pkg, "*.py"))}}

DELIBERATE = {
    # a JAX pytree registration helper; the port's models are dataclasses
    "kernels/base.py": {"pytree_dataclass"},
    # JAX NamedSharding builders: a rank of the port holds its rows as
    # ordinary tensors (`shard_batch`, `shard_rows`) and the model as is
    "parallel/mesh.py": {"data_sharding", "replicated"},
}


def public_names(path):
    out = set()
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{sub.name}" for sub in node.body
                        if isinstance(sub, ast.FunctionDef) and not sub.name.startswith("_")}
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name) and t.id.isupper()
                    and not t.id.startswith("_")}
    return out


@pytest.mark.parametrize("jax_module", sorted(MODULES))
def test_torch_port_has_the_jax_public_names(jax_module):
    want = public_names(os.path.join(REPO, "portfoliooptgp_tpu", jax_module))
    got = public_names(os.path.join(REPO, "portfoliooptgp_tpu_torch", MODULES[jax_module]))
    assert want - got == DELIBERATE.get(jax_module, set())
