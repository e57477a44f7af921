"""The one error raised for an option of the JAX package that the port lacks."""


def not_ported(what: str, roadmap_item: str) -> NotImplementedError:
    """``NotImplementedError`` naming the ROADMAP.md item that will port ``what``."""
    return NotImplementedError(
        f"{what} is not ported to bayesian_ensembling_tpu_torch yet "
        f"(ROADMAP.md item {roadmap_item}); use bayesian_ensembling_tpu for it"
    )
