"""Offline data generation on the host (numpy): TSDF fusion, mesh rendering,
marching tetrahedra, the SceneSampler's chunk and scene export, virtual
scans, synthetic color scenes and ``.sens`` frame export. Copies of the JAX
package's ``tpu3dsis/datagen/``."""
