"""The LM substrate of the port: dense and VLM decoder-only transformers
(`transformer.LM`), their layers and attention, float and W8A8."""
