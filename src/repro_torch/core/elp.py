"""Example Level Parallelism (the part of ``repro/core/elp.py`` the launcher needs)."""


def elp(batch_size: int, n_hogwild: int, n_replicas: int) -> int:
    """Examples processed concurrently at any instant. Two-level data
    parallelism: Hogwild within a trainer x replication across."""
    return batch_size * n_hogwild * n_replicas
