"""Human3.6m download and extraction (counterpart of
``ipoke_tpu/data/human36m_preprocess.py``, the reference's
``data/human36m_preprocess.py``): authenticated download of the official
video tarballs per subject, extraction, and the video listing for
``ipoke_tpu_torch.data.prep``.

Credentials come from ``data_config.ini`` (section ``h36m``: user, password)
like the reference's ``data/config.ini``.  The download needs the
dataset's site and an account; ``extract`` and ``list_videos`` work on
tarballs already on disk.

    python -m ipoke_tpu_torch.data.human36m_preprocess --out_dir DIR
        [--credentials data_config.ini] [--split train|test|all]
"""

from __future__ import annotations

import argparse
import configparser
import glob
import os
import tarfile
import urllib.parse
import urllib.request

SUBJECTS = {  # official train 1,5,6,7,8 / test 9,11 split
    "train": ["S1", "S5", "S6", "S7", "S8"],
    "test": ["S9", "S11"],
}
BASE_URL = "http://vision.imar.ro/human3.6m/filebrowser.php"


def login_and_download(user: str, password: str, subject: str, out_dir: str):
    data = urllib.parse.urlencode(
        {"username": user, "password": password}).encode()
    req = urllib.request.Request(
        f"{BASE_URL}?download=1&filepath=Videos&filename={subject}.tgz",
        data=data)
    os.makedirs(out_dir, exist_ok=True)
    target = os.path.join(out_dir, f"{subject}.tgz")
    with urllib.request.urlopen(req) as r, open(target, "wb") as f:
        while chunk := r.read(1 << 20):
            f.write(chunk)
    return target


def extract(tgz_path: str, out_dir: str):
    with tarfile.open(tgz_path) as tf:
        tf.extractall(out_dir, filter="data")


def list_videos(root: str):
    return sorted(glob.glob(os.path.join(root, "**", "*.mp4"),
                            recursive=True))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out_dir", required=True)
    p.add_argument("--credentials", default="data_config.ini")
    p.add_argument("--split", choices=["train", "test", "all"], default="all")
    args = p.parse_args()
    cfg = configparser.ConfigParser()
    cfg.read(args.credentials)
    user, pw = cfg["h36m"]["user"], cfg["h36m"]["password"]
    subjects = (SUBJECTS["train"] + SUBJECTS["test"]
                if args.split == "all" else SUBJECTS[args.split])
    for s in subjects:
        tgz = login_and_download(user, pw, s, args.out_dir)
        extract(tgz, args.out_dir)
    print(f"{len(list_videos(args.out_dir))} videos ready; run "
          f"ipoke_tpu_torch.data.prep --mode all next")


if __name__ == "__main__":
    main()
