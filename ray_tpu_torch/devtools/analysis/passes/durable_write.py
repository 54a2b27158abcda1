"""durable-write: binary writes to persistent paths in the runtime
core must be crash-atomic or justify why tearing is acceptable.

A raw ``open(path, "wb")`` (or ``np.save``/``np.savez``/
``pickle.dump`` straight onto a final path) in ``_private/`` or
``train/`` is a latent torn file: a crash mid-write corrupts the ONLY
copy under the final name — the motivating instances were the GCS
persisted snapshot and ``train/checkpoint.save_pytree``, both of
which wrote in place. The rule is structural: inside the scoped
trees, every

- ``open(..., mode)`` whose literal mode is a binary write
  (``wb``/``ab``/``xb`` variants),
- ``np.save`` / ``np.savez`` / ``np.savez_compressed``, and
- ``pickle.dump`` / ``cloudpickle.dump``

must either route through the shared atomic helper
(``ray_tpu_torch/_private/durable.py`` — tmp + fsync + rename; that module
itself is exempt, it IS the pattern) or carry a
``# non-durable-ok: <why>`` comment naming the reason a torn write is
survivable (append-only log streams, spill files whose loss lineage
reconstruction absorbs, files staged inside a dir that is itself
atomically renamed, ...) — on the call's lines or in the contiguous
comment block directly above it.

Scope: ``_private/`` and ``train/`` (and the lint fixtures).
``collective/`` routes its rank files through the helper too, but the
library layers above write user files under user control.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from ray_tpu_torch.devtools.analysis.core import (FileContext, Finding,
                                            suppressed_by_mark)

PASS_ID = "durable-write"
VERSION = 5   # v5: cluster autoscaler (ray_tpu_torch/autoscaler/)

_SCOPES = ("_private/", "train/", "multislice/",
           "serve/", "data/", "autoscaler/", "analysis_fixtures/")
_EXEMPT_FILES = ("_private/durable.py",)

_SUPPRESS_MARK = "non-durable-ok:"

# module-attribute calls that serialize straight onto their target
_ATTR_WRITERS = {
    ("np", "save"), ("numpy", "save"),
    ("np", "savez"), ("numpy", "savez"),
    ("np", "savez_compressed"), ("numpy", "savez_compressed"),
    ("pickle", "dump"), ("cloudpickle", "dump"),
}


def _binary_write_mode(node: ast.Call) -> Optional[str]:
    """The literal mode string iff this ``open(...)`` call is a binary
    write; None otherwise (reads, text writes, and non-literal modes
    are out of scope — text writes carry configs/markers whose
    callers own the durability decision, and a computed mode can't be
    judged statically)."""
    mode_node: Optional[ast.AST] = None
    if len(node.args) > 1:
        mode_node = node.args[1]
    for kw in node.keywords:
        if kw.arg == "mode":
            mode_node = kw.value
    if not isinstance(mode_node, ast.Constant) \
            or not isinstance(mode_node.value, str):
        return None
    mode = mode_node.value
    if "b" in mode and any(c in mode for c in "wax"):
        return mode
    return None


def check_file(ctx: FileContext) -> List[Finding]:
    if not any(scope in ctx.path for scope in _SCOPES):
        return []
    if any(ctx.path.endswith(exempt) for exempt in _EXEMPT_FILES):
        return []
    findings: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        label = None
        if isinstance(node.func, ast.Name) and node.func.id == "open":
            mode = _binary_write_mode(node)
            if mode is not None:
                label = f"open(..., {mode!r})"
        elif isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Name):
            pair = (node.func.value.id, node.func.attr)
            if pair in _ATTR_WRITERS:
                label = f"{pair[0]}.{pair[1]}(...)"
        if label is None:
            continue
        if suppressed_by_mark(ctx, node, _SUPPRESS_MARK):
            continue
        findings.append(Finding(
            PASS_ID, ctx.path, node.lineno, ctx.scope_of(node),
            f"raw binary write {label}: a crash mid-write tears the "
            "only copy under the final name — route through "
            "_private/durable.py (tmp + fsync + rename) or annotate "
            "`# non-durable-ok: <why a torn file is survivable>`"))
    return findings
