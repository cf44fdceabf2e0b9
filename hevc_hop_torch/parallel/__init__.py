"""Frames x row-band meshes (counterpart of hevc_hop_tpu/parallel/).

mesh.py          the Mesh (virtual: every cell in this process; process:
                 one cell per torch.distributed rank) and the sharded
                 dense mode analysis, kernel C2's analysis entry
shard_encode.py  MeshIntraEncoder, the banded level loop over C2 and C3
                 with a one-row recon halo refreshed after every level
"""
