"""Map-sharded odometry over a seq x map grid of processes (torch.distributed):
the map partitioned into voxel blocks, one block per process, with collective
kNN merges and all-reduced Gauss-Newton normal equations."""
