from paths_tpu_torch.viz.heatmap import heatmap_slide, parse_camelyon17_anno_file  # noqa: F401
