"""Cost analysis and roofline of the port: the counterpart of
``repro.analysis``.

``cost`` counts a step's work as it runs, eagerly, on meta tensors (flops,
bytes, collectives, the kernels' reported work, peak live bytes): the
counterpart of ``hlo_analysis``, which parses the reference's compiled HLO.
``roofline`` turns a count into compute, memory and collective times on
one NVIDIA H100, and holds the model-FLOPs conventions and each kernel's
work and bound.
"""
