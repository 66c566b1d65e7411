"""The scripts that run only on a card import what the package has: every
import of lichtfeld_studio_tpu_torch in them, those inside functions
included, resolves on the CPU. No CPU test runs these scripts, so a stale
import would otherwise first show on a card."""

import ast
import importlib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PACKAGE = "lichtfeld_studio_tpu_torch"
SCRIPTS = ("chip_smoke.py", f"{PACKAGE}/tools/ab_kernels.py", f"{PACKAGE}/tools/ablate_kernels.py",
           f"{PACKAGE}/tools/gut_pose_step.py", f"{PACKAGE}/bench_dp.py")


def package_imports(path: Path):
    """(module, name) of each `from <package...> import name`, and (module,
    None) of each `import <package...>`, anywhere in the file."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module.split(".")[0] == PACKAGE:
            yield from ((node.module, alias.name) for alias in node.names)
        elif isinstance(node, ast.Import):
            yield from ((alias.name, None) for alias in node.names
                        if alias.name.split(".")[0] == PACKAGE)


def resolves(module: str, name: str | None) -> bool:
    """The module imports and has `name`, as an attribute or a submodule."""
    try:
        mod = importlib.import_module(module)
        if name is None or hasattr(mod, name):
            return True
        importlib.import_module(f"{module}.{name}")
    except ModuleNotFoundError:
        return False
    return True


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda s: Path(s).name)
def test_package_imports_of_a_card_script_resolve(script):
    found = list(package_imports(REPO / script))
    assert found, script
    missing = [f"{m}.{n}" if n else m for m, n in found if not resolves(m, n)]
    assert not missing, missing
