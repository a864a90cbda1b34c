"""Observability: the cross-tier trace spans the serving wire carries."""
