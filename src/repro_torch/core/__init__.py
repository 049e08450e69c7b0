"""Semantic core: config, params, RNG, auction, agents, step, stats, session."""
