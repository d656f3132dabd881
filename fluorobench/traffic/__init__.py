"""Traffic: the parameters of each mix (``<name>.json``) and the seeded
generators they drive."""
