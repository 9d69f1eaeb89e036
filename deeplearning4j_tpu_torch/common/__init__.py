"""Shared plumbing: the JSON serde copy (``common.serde``) and
:func:`not_ported`, the error every stand-in of the port raises."""


def not_ported(what: str, item: str) -> NotImplementedError:
    """The ``NotImplementedError`` for a part of the JAX package that the
    port does not have yet, naming its ROADMAP.md item."""
    return NotImplementedError(
        f"{what} is not ported to deeplearning4j_tpu_torch yet "
        f"(ROADMAP.md {item})")
