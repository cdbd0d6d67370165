"""Inference and evaluation of the port: the forward, the COCO evaluator, the
Cityscapes and CVPPP exporters, the metrics, and the overlay renderer."""
