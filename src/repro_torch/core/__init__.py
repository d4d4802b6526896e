"""Float reference pieces: the float squash the pipeline reuses, and
Sabour's float dynamic routing (Algorithm 1)."""
