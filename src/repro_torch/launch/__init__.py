"""The port's launch layer: command-line front ends (``python -m
repro_torch.launch.serve``, ``python -m repro_torch.launch.train``), the
process groups and device meshes (``mesh``), the assigned input shapes
(``specs``), the sharding policy (``sharding``) and pipeline-parallel
decode (``pipeline_decode``)."""
