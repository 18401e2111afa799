"""QPART's decision layer: quantizer, noise model, partitioning, cost
model and solver."""
from repro_torch.core.cost_model import (  # noqa: F401
    Channel, CostBreakdown, DeviceProfile, LayerSpec, ObjectiveWeights,
    ServerProfile, cost_breakdown, classifier_layer_specs, delta_coeff,
    eps_coeff, layer_specs_for, transformer_layer_specs, xi_coeff,
)
from repro_torch.core.noise import (  # noqa: F401
    LayerNoiseProfile, NoiseCalibration, adversarial_noise_energy,
    calibrate_delta, output_noise_energy,
)
from repro_torch.core.partition import (  # noqa: F401
    DeviceSegment, split_classifier,
)
from repro_torch.core.quantizer import (  # noqa: F401
    analytic_noise_scale, dequantize, fake_quant, payload_bits,
    quant_noise_energy, quantize, quantize_tree, round_bits,
)
from repro_torch.core.solver import (  # noqa: F401
    BitSolution, OfflineStore, PartitionPlan, SegmentItems,
    build_offline_store, plan_for_partition, solve_joint, waterfill_bits,
)
