"""Float reference pieces the pipeline reuses (the float squash)."""
