"""Multi-device distribution of the torch port: the device list, the
image-space sharding strategies, the stitch and dynamic load balancing
(reference: src/distribution_strategy.cc, src/stitch_stage.cc,
src/load_balancer.cc); the counterpart of tauray_tpu.parallel.

tauray_tpu shards one frame over a jax.sharding.Mesh; the port takes an
explicit list of torch.devices (`make_devices`), traces each workload's
pixels on its device and stitches the partial frames on the first one.
"""

from .distribution import (DistributionStrategy, calculate_shuffled_strips_b,
                           get_device_distribution_params, permute_region_id)
from .mesh import make_devices
from .load_balancer import LoadBalancer
