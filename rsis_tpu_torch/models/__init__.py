"""Backbones, encoder, ConvLSTM decoder and the decode loops of the port."""
