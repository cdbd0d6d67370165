"""Dataset tools: palettes and the Pascal VOC mask precompute."""
