"""Records, or compares, the statements of the port's runtime modules.

``tests/data/torch_ast_digests.json`` holds one SHA-256 per ``.py`` file of
``sboxgates_tpu_torch/`` outside ``analysis/``: the digest of the module's
AST dump without line numbers, the form of ``ast.dump`` that leaves out
fields that are None or an empty list (Python 3.13's default).  Comments
and formatting change no digest; any statement does.  Leaving the empty
fields out keeps a digest the same on every Python version that parses
the module to the same tree.

``tests/test_torch_lint.py`` holds the tree to the recorded digests.  A
change that alters a statement on purpose records them again, from the
root of a checkout:

    python tests/torch_ast_digests.py

and names each module it changed in its notes.  To list the modules whose
statements differ between a git revision and the working tree:

    python tests/torch_ast_digests.py --diff REV
"""

import argparse
import ast
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "sboxgates_tpu_torch"
DIGESTS = os.path.join(ROOT, "tests", "data", "torch_ast_digests.json")


def stable_dump(node) -> str:
    """``ast.dump`` without attributes, None fields or empty lists."""
    if isinstance(node, ast.AST):
        parts = []
        for name in node._fields:
            value = getattr(node, name, None)
            if value is None or value == []:
                continue
            parts.append(f"{name}={stable_dump(value)}")
        return f"{type(node).__name__}({', '.join(parts)})"
    if isinstance(node, list):
        return "[" + ", ".join(stable_dump(v) for v in node) + "]"
    return repr(node)


def digest(source: str) -> str:
    return hashlib.sha256(stable_dump(ast.parse(source)).encode()).hexdigest()


def runtime_modules(root: str = ROOT) -> list:
    """Paths, relative to ``root``, of the port's modules outside
    ``analysis/``."""
    out = []
    for dirpath, dirnames, filenames in os.walk(os.path.join(root, PACKAGE)):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("analysis", "__pycache__"))
        rel = os.path.relpath(dirpath, root)
        out += [os.path.join(rel, f).replace(os.sep, "/")
                for f in sorted(filenames) if f.endswith(".py")]
    return sorted(out)


def tree_digests(root: str = ROOT) -> dict:
    out = {}
    for rel in runtime_modules(root):
        with open(os.path.join(root, rel), encoding="utf-8") as f:
            out[rel] = digest(f.read())
    return out


def diff(rev: str) -> list:
    """Modules whose statements differ between ``rev`` and the tree (a
    module on one side only counts as differing)."""
    now = tree_digests()
    listed = subprocess.run(
        ["git", "ls-tree", "-r", "--name-only", rev, PACKAGE + "/"],
        cwd=ROOT, check=True, capture_output=True, text=True).stdout.split()
    then = {}
    for rel in listed:
        if rel.endswith(".py") and not rel.startswith(PACKAGE + "/analysis/"):
            source = subprocess.run(["git", "show", f"{rev}:{rel}"], cwd=ROOT,
                                    check=True, capture_output=True,
                                    text=True).stdout
            then[rel] = digest(source)
    return sorted(rel for rel in set(now) | set(then)
                  if now.get(rel) != then.get(rel))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--diff", metavar="REV",
                    help="list the modules whose statements differ from REV")
    args = ap.parse_args(argv)
    if args.diff:
        for rel in diff(args.diff):
            print(rel)
        return 0
    with open(DIGESTS, "w", encoding="utf-8") as f:
        json.dump({"ast_dump_sha256": tree_digests()}, f, indent=1,
                  sort_keys=True)
        f.write("\n")
    print(f"{len(tree_digests())} modules recorded in "
          f"{os.path.relpath(DIGESTS, ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
