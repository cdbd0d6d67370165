"""The plain PyTorch reference of RSIS that decides ``correct``.

It imports neither JAX nor ``rsis_tpu`` nor anything of
``rsis_tpu_torch``: the model (``model.py``, written from the reference
architecture over a state_dict in its key layout), the inference forward
(``infer.py``), the train step with its augmentation, matcher, losses and
optimizer (``train.py``, ``lap.py``) and the operand precisions of the
controls (``precision.py``) are its own.
"""
