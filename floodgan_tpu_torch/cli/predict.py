"""Batch inference CLI of the port: the root predict.py's flags, plus --device.

    python -m floodgan_tpu_torch.cli.predict --pretrained_model_path model.ckpt \\
        --inputs a.tif b.tif --output_dir out/ [--resize 512] [--batch_size 0]

Reads 9-channel input stacks (dataset_input TIFFs), runs the generator of
the checkpoint on the card (unless ``--device cpu``), and writes each
post-flood prediction as ``<name>_prediction.png``, with the pixels that
matplotlib's ``imsave`` would write (``utils/png.py``).  With
``--segmentation_model_path`` it also writes each prediction's flood mask
from that U-Net as ``<name>_floodmask.png`` (the gray colormap), one image
per U-Net call: batch norm normalises with the batch's statistics, so
batching the calls would change the masks.
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pretrained_model_path", required=True)
    p.add_argument("--inputs", nargs="+", required=True, help="9-channel input stack TIFFs")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--resize", type=int, default=512)
    p.add_argument("--segmentation_model_path", default=None,
                   help="Also write flood masks from this segmentation checkpoint")
    p.add_argument("--batch_size", type=int, default=0, help="0 = all inputs in one batch")
    p.add_argument("--device", default=None, help="The card by default (cuda); 'cpu' runs the plain versions")
    return p


def main(argv=None) -> list:
    """Predict as the flags say; returns the PNG paths written."""
    args = build_parser().parse_args(argv)

    import numpy as np

    from floodgan_tpu_torch.data import tiff
    from floodgan_tpu_torch.serve import InferenceEngine
    from floodgan_tpu_torch.utils.png import imsave_gray, imsave_rgb

    os.makedirs(args.output_dir, exist_ok=True)
    batch = args.batch_size or len(args.inputs)
    engine = InferenceEngine.from_checkpoint(
        args.pretrained_model_path, batch_size=batch, image_size=args.resize, device=args.device
    )
    seg = None
    if args.segmentation_model_path:
        from floodgan_tpu_torch.api.segmentation import SegmentationModel

        seg = SegmentationModel(pretrained_model_path=args.segmentation_model_path, train=False, skip_data=True,
                                verbose=False, data_path=args.output_dir, device=args.device)
    written = []
    for start in range(0, len(args.inputs), batch):
        chunk = args.inputs[start:start + batch]
        stacks = np.stack([np.asarray(tiff.imread(f), np.float32) for f in chunk])
        x = engine.preprocess(stacks, resize=args.resize)
        outputs = engine.predict(x)
        for path, img in zip(chunk, outputs):
            name = os.path.splitext(os.path.basename(path))[0]
            out_png = os.path.join(args.output_dir, f"{name}_prediction.png")
            imsave_rgb(out_png, np.clip(img.cpu().numpy(), 0, 1))
            print(f"wrote {out_png}")
            written.append(out_png)
            if seg is not None:
                mask = seg.predict_mask(img[None])[0, :, :, 0].cpu().numpy()
                mask_png = os.path.join(args.output_dir, f"{name}_floodmask.png")
                imsave_gray(mask_png, mask)
                print(f"wrote {mask_png}")
                written.append(mask_png)
    return written


if __name__ == "__main__":
    main()
