"""The port's distribution layer (counterpart of ``repro.dist``).

So far only :mod:`~repro_torch.dist.faults`, the single-device half of
``repro.dist.faults``: seedable payload and gradient faults for the KV
append and the train step.  Sharding, the compressed collectives, the
pipeline, error feedback and the pod train step come with dist (M7); the
single-device train step is :mod:`repro_torch.train.step`.
"""
