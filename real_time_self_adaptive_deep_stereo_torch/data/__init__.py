from real_time_self_adaptive_deep_stereo_torch.data.readers import (  # noqa: F401
    StereoDataset,
    augment,
    center_crop_or_pad,
    load_gt,
    load_image,
    prefetch_to_device,
    random_crop,
    read_list_file,
    read_pfm,
)
