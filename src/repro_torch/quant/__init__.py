"""Integer oracle (int8_ops) and Qm.n format calculus (qformat)."""
