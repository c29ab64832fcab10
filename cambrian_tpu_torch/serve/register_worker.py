"""Manually register a worker with the controller
(reference serve/register_worker.py).

The port's copy of cambrian_tpu/serve/register_worker.py, which imports nothing
of the JAX package.
"""

import argparse

import requests

if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--controller-address", type=str, required=True)
    parser.add_argument("--worker-name", type=str, required=True)
    parser.add_argument("--check-heart-beat", action="store_true")
    args = parser.parse_args()

    url = args.controller_address + "/register_worker"
    data = {
        "worker_name": args.worker_name,
        "check_heart_beat": args.check_heart_beat,
        "worker_status": None,
    }
    r = requests.post(url, json=data)
    assert r.status_code == 200
