from tpu3dsis_torch.eval.detection_map import APAccumulator, DetectionMAP

__all__ = ["APAccumulator", "DetectionMAP"]
