"""Multi-GPU training and batched solves over ``torch.distributed``.

``sharding`` holds the mesh, the collectives and the tensor-parallel MLP;
``launch`` starts the ranks of a run on one host.
"""
