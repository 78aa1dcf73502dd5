"""Distribution layer of the port: the rule table, parameter and batch
placements on a ``DeviceMesh``, the ambient ``ParallelCtx``, the
expert- and tensor-parallel MoE and the ring collective matmul."""
