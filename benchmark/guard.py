"""The import guard: nothing of JAX or of the JAX package may be loaded in a
run. Module names are compared by their top-level name (the part before the
first dot) as a whole, because the port's name, whisper_vits_svc_tpu_torch,
begins with the JAX package's."""

from __future__ import annotations

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "whisper_vits_svc_tpu"})


def loaded_forbidden(module_names) -> list[str]:
    """The names in `module_names` whose top-level name is forbidden."""
    return sorted(n for n in module_names if n.split(".", 1)[0] in FORBIDDEN)
