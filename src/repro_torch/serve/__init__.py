"""LM serving: the continuous-batching ``engine`` over the runtime's slot
pool, and the token ``sampler``."""
