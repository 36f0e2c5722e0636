"""Model library in PyTorch: the decoder transformer (dense, MoE, VLM), xLSTM and Zamba2."""
