"""The LM substrate of the port: decoder-only LMs of attention, SWA,
mamba, mLSTM and sLSTM blocks with MLP or MoE FFNs (`transformer.LM`,
dense, VLM, MoE, SSM and hybrid) and the encoder-decoder
(`transformer.EncDecLM`), their layers, attention, MoE and recurrent
mixers, float and W8A8."""
